"""Enforce: structured errors with the reference's error taxonomy
(counterpart: ``paddle_tpu/core/enforce.py``, a copy: it is backend-neutral).

Reference: `paddle/fluid/platform/enforce.h` (PADDLE_ENFORCE* macros with
call-site capture) + `platform/errors.cc` / `error_codes.proto` (the typed
error categories: InvalidArgument, NotFound, OutOfRange, AlreadyExists,
ResourceExhausted, PreconditionNotMet, PermissionDenied, ExecutionTimeout,
Unimplemented, Unavailable, Fatal, External).

Python redesign: each category is an exception class carrying the formatted
message plus the enforce call site (file:line of the caller, the analog of
the macro's __FILE__/__LINE__ capture); `enforce*` helpers raise them with
the reference's "Expected ... , but received ..." phrasing.
"""
import inspect
import os

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError",
    "enforce", "enforce_eq", "enforce_ne", "enforce_gt", "enforce_ge",
    "enforce_lt", "enforce_le", "enforce_not_none",
]


class EnforceNotMet(RuntimeError):
    """Base (reference: EnforceNotMet enforce.h) — message + call site."""

    code = "ENFORCE_NOT_MET"

    def __init__(self, message, caller_depth=1):
        frame = inspect.stack()[caller_depth + 1] if len(
            inspect.stack()) > caller_depth + 1 else None
        self.call_site = (f"{os.path.basename(frame.filename)}:{frame.lineno}"
                          if frame else "<unknown>")
        super().__init__(f"{message}\n  [Hint: {self.code} at "
                         f"{self.call_site}]")


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


def enforce(cond, message="", error_cls=InvalidArgumentError):
    """PADDLE_ENFORCE analog."""
    if not cond:
        raise error_cls(message, caller_depth=1)


def _cmp(a, b, op, sym, message, error_cls):
    if not op(a, b):
        raise error_cls(
            f"{message} Expected lhs {sym} rhs, but received lhs={a!r} "
            f"vs rhs={b!r}.", caller_depth=2)


def enforce_eq(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x == y, "==", message, error_cls)


def enforce_ne(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x != y, "!=", message, error_cls)


def enforce_gt(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x > y, ">", message, error_cls)


def enforce_ge(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x >= y, ">=", message, error_cls)


def enforce_lt(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x < y, "<", message, error_cls)


def enforce_le(a, b, message="", error_cls=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x <= y, "<=", message, error_cls)


def enforce_not_none(x, message="", error_cls=NotFoundError):
    if x is None:
        raise error_cls(message or "Expected a value, got None.",
                        caller_depth=1)
    return x
