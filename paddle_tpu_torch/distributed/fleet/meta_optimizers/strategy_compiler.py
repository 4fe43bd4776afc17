"""The strategy compiler (counterpart: ``meta_optimizers/
strategy_compiler.py``): a ``DistributedStrategy`` -> the ordered stack of
meta-optimizers, conflicts resolved with the reference's rules and
warnings. Order is nesting, innermost first: DGC, LARS and LAMB rebuild
the base optimizer as their class, then the state layout (``sharding``),
the gradient transforms, the step gates and the loss scaling outermost.
``adaptive_localsgd`` selects nothing, as in the reference."""
import warnings


class StrategyCompiler:
    ORDER = ["dgc", "lars", "lamb", "sharding", "fp16_allreduce",
             "gradient_merge", "localsgd", "asp", "amp"]

    def resolve(self, strategy, hcg, inner_optimizer):
        """The ordered ``[(name, factory)]``; ``factory(opt) -> opt``."""
        from ....optimizer.optimizer import SGD, Adam, Momentum
        from .amp import AMPOptimizer
        from .asp import ASPOptimizer
        from .fp16_allreduce import FP16AllReduceOptimizer
        from .gradient_merge import GradientMergeOptimizer
        from .localsgd import LocalSGDOptimizer
        from .sharding import DygraphShardingOptimizer

        chosen = {}
        if hcg is not None and (strategy.sharding
                                or hcg.get_sharding_parallel_world_size() > 1):
            chosen["sharding"] = lambda opt: DygraphShardingOptimizer(
                opt, hcg, strategy=strategy)
        if strategy.dgc:
            # the reference's dgc_optimizer._can_apply: Momentum only
            if isinstance(inner_optimizer, Momentum):
                cfg = strategy.dgc_configs
                chosen["dgc"] = lambda opt: _rebuild_as_dgc(opt, cfg)
            else:
                warnings.warn("strategy.dgc needs a Momentum inner optimizer"
                              " (reference dgc_optimizer._can_apply); skipped")
        if strategy.lars:
            if type(inner_optimizer) in (Momentum, SGD):
                cfg = strategy.lars_configs
                chosen["lars"] = lambda opt: _rebuild_as_lars(opt, cfg)
            else:
                warnings.warn("strategy.lars needs Momentum/SGD; skipped")
        if strategy.lamb:
            if isinstance(inner_optimizer, Adam):
                cfg = strategy.lamb_configs
                chosen["lamb"] = lambda opt: _rebuild_as_lamb(opt, cfg)
            else:
                warnings.warn("strategy.lamb needs Adam; skipped")
        if getattr(strategy, "fp16_allreduce", False):
            chosen["fp16_allreduce"] = lambda opt: FP16AllReduceOptimizer(opt)
        if strategy.gradient_merge:
            cfg = strategy.gradient_merge_configs
            chosen["gradient_merge"] = lambda opt: GradientMergeOptimizer(
                opt, k_steps=cfg.get("k_steps", 1), avg=cfg.get("avg", True))
        if strategy.localsgd:
            if strategy.dgc and "dgc" in chosen:
                # the reference's conflict rule: dgc and localsgd exclude
                # each other
                warnings.warn("strategy.localsgd conflicts with dgc; "
                              "dgc wins (reference conflict resolution)")
            else:
                group = (hcg.get_data_parallel_group()
                         if hcg is not None else None)
                k = strategy.localsgd_configs.get("k_steps", 1) or 1
                chosen["localsgd"] = lambda opt: LocalSGDOptimizer(
                    opt, k_steps=k, group=group)
        if getattr(strategy, "asp", False):
            chosen["asp"] = lambda opt: ASPOptimizer(opt)
        if strategy.amp:
            chosen["amp"] = lambda opt: AMPOptimizer(opt, strategy.amp_configs)
        return [(name, chosen[name]) for name in self.ORDER if name in chosen]

    @staticmethod
    def apply(stack, optimizer):
        for _, factory in stack:
            optimizer = factory(optimizer)
        return optimizer


def _clone_common(opt):
    return dict(parameters=[p for g in opt._param_groups
                            for p in g["params"]],
                grad_clip=opt._grad_clip)


def _rate(opt):
    return opt._lr.scheduler or opt.get_lr()


def _rebuild_as_dgc(opt, cfg):
    """The reference replaces Momentum with DGCMomentum; a wrapper cannot
    change the update rule, so the optimizer is rebuilt as its DGC
    variant over the same parameters."""
    from .dgc import DGCMomentumOptimizer
    return DGCMomentumOptimizer(
        learning_rate=_rate(opt),
        momentum=getattr(opt, "_momentum", 0.9),
        rampup_begin_step=cfg.get("rampup_begin_step", 0),
        rampup_step=cfg.get("rampup_step", 1),
        sparsity=cfg.get("sparsity", [0.999]),
        weight_decay=opt._weight_decay, **_clone_common(opt))


def _rebuild_as_lars(opt, cfg):
    from ....optimizer.optimizer import Lars
    return Lars(
        learning_rate=_rate(opt),
        momentum=getattr(opt, "_momentum", 0.9),
        lars_coeff=cfg.get("lars_coeff", 0.001),
        lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
        **_clone_common(opt))


def _rebuild_as_lamb(opt, cfg):
    from ....optimizer.optimizer import Lamb
    return Lamb(
        learning_rate=_rate(opt),
        lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
        beta1=getattr(opt, "_beta1", 0.9), beta2=getattr(opt, "_beta2", 0.999),
        epsilon=getattr(opt, "_eps", 1e-6), **_clone_common(opt))
