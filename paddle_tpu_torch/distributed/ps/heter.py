"""Heterogeneous PS training (counterpart: ``paddle_tpu/distributed/ps/
heter.py``; the reference framework's `distributed/service/
heter_client.h:67` / `heter_server.h:151` + `framework/
heterxpu_trainer.cc` — CPU workers run the sparse/embedding stage and
exchange ACTIVATIONS with accelerator trainers over RPC
(SendAndRecvAsync); the trainer runs the dense stage forward+backward and
returns the activation gradients).

The worker (host) pulls sparse rows from the PS, computes the embedding
stage, ships the activations to the trainer over a length-prefixed socket
channel, receives d(loss)/d(activations) back, completes the sparse
backward and pushes the gradients to the PS. The trainer owns the dense
parameters, runs its handler on the card and updates them per batch.

The frame is the reference's, byte for byte (the magic ``0x31485450``, a
little-endian u32 length, then an ``np.savez`` payload of ``a0``, ``a1``,
...), so either package's client talks to either package's server. A
one-array reply is a trainer-side failure, which the client raises.
"""
import io
import socket
import struct
import threading

import numpy as np

__all__ = ["HeterServer", "HeterClient", "start_heter_server"]

_MAGIC = 0x31485450  # b"PTH1": frame magic/version word


def _send_arrays(sock, arrays):
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
    payload = buf.getvalue()
    sock.sendall(struct.pack("<II", _MAGIC, len(payload)) + payload)


def _recv_arrays(sock):
    hdr = _recv_exact(sock, 8)
    magic, ln = struct.unpack("<II", hdr)
    if magic != _MAGIC:
        raise ConnectionError(
            f"bad heter frame magic {magic:#010x} (expected {_MAGIC:#010x} "
            f"— protocol version mismatch or stray peer)")
    buf = io.BytesIO(_recv_exact(sock, ln))
    with np.load(buf) as z:
        return [z[f"a{i}"] for i in range(len(z.files))]


def _recv_exact(sock, n):
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("heter peer closed connection")
        got += k
    return bytes(out)


class HeterServer:
    """Trainer-side endpoint (reference: HeterServer::SendAndRecvAsync
    handlers). `handler(activations, labels) -> (loss, d_activations)`
    runs the dense stage forward+backward+update per request; it gets
    numpy arrays and returns a float (or a 0-d array or tensor) and an
    array (or a tensor, read back to the host)."""

    def __init__(self, handler, port=0, host="127.0.0.1"):
        # loopback by default: the channel is unauthenticated (a reachable
        # peer could stop the trainer or inject batches); bind wider only
        # deliberately
        self.handler = handler
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                arrays = _recv_arrays(conn)
                if len(arrays) == 1 and arrays[0].shape == ():  # STOP
                    _send_arrays(conn, [np.zeros(())])
                    self.stop()
                    return
                acts, labels = arrays
                try:
                    loss, dacts = self.handler(acts, labels)
                    reply = [_host(loss), _host(dacts)]
                except Exception as e:  # noqa: BLE001 -- sent to the worker
                    # a 1-element error frame the client re-raises (the
                    # remote failure would otherwise surface as an opaque
                    # ConnectionError)
                    _send_arrays(conn, [np.asarray(f"HETER_ERROR: {e}")])
                    continue
                _send_arrays(conn, reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        """Stop accepting: ``serve_forever`` returns (the listening
        socket is shut down first, which wakes a blocked ``accept``; a
        close alone does not)."""
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def _host(v):
    """A handler's result as a host array (a tensor is read back)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def start_heter_server(handler, port=0):
    """Start on a daemon thread; returns (server, port)."""
    srv = HeterServer(handler, port=port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.port


class HeterClient:
    """Worker-side channel (reference: HeterClient::SendAndRecvAsync)."""

    def __init__(self, endpoint):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=120)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._mu = threading.Lock()

    def send_and_recv(self, activations, labels):
        """Ship the embedding-stage output; get (loss, d_activations)."""
        # lint: blocking-call-under-lock the mutex serializes the stage channel's request/reply framing — interleaved writers would corrupt the array stream; the lock is a leaf (nothing is held around send_and_recv)
        with self._mu:
            _send_arrays(self._sock, [_host(activations), _host(labels)])
            arrays = _recv_arrays(self._sock)
            if len(arrays) == 1:  # trainer-side handler failure
                raise RuntimeError(str(arrays[0]))
            loss, dacts = arrays
            return float(loss), dacts

    def stop_server(self):
        # lint: blocking-call-under-lock same wire-framing serialization as send_and_recv; shutdown-path only
        with self._mu:
            try:
                _send_arrays(self._sock, [np.zeros(())])
                _recv_arrays(self._sock)
            except (ConnectionError, OSError):
                pass

    def close(self):
        self._sock.close()
