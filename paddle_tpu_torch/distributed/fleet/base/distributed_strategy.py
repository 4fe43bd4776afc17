"""DistributedStrategy (counterpart:
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``): the same
plain-Python field surface, read by ``fleet.init`` (``hybrid_configs``),
``fleet.distributed_model`` (``pipeline_configs``, ``recompute``) and
``fleet.distributed_optimizer`` (the meta-optimizer switches and their
``*_configs``: ``sharding``, ``dgc``, ``lars``, ``lamb``, ``fp16_allreduce``,
``gradient_merge``, ``localsgd``, ``asp``, ``amp``). ``adaptive_localsgd``
is a field that selects nothing, as in the reference."""
import copy


class DistributedStrategy:
    def __init__(self):
        # hybrid mesh degrees (proto :48-51)
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
        }
        # AMP (proto :56-65)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0,
            "decr_ratio": 0.5,
            "use_dynamic_loss_scaling": True,
            "use_pure_fp16": False,
            "use_bf16": True,
            "custom_white_list": [],
            "custom_black_list": [],
        }
        # recompute (proto; reference :476)
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        # sharding / ZeRO (reference :788)
        self.sharding = False
        self.sharding_configs = {
            "stage": 1,
            "segment_broadcast_MB": 32.0,
            # gradient-reduction bucket cap for the ZeRO-1/2 flat path
            # (the dygraph analog of segment_broadcast_MB): one
            # psum_scatter per comm_buffer_size_MB of fp32 grads
            "comm_buffer_size_MB": 25.0,
            "offload": False,
        }
        # pipeline (reference :950)
        self.pipeline = False
        self.pipeline_configs = {
            "accumulate_steps": 1,
            "micro_batch_size": 1,
            "schedule_mode": "1F1B",
        }
        # tensor parallel (reference :1014)
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        # gradient merge
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        # comm-efficiency knobs (fields only)
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.adaptive_localsgd = False
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.fp16_allreduce = False
        self.asp = False
        self.a_sync = False
        self.a_sync_configs = {}
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def __deepcopy__(self, memo):
        new = DistributedStrategy()
        for k, v in self.__dict__.items():
            setattr(new, k, copy.deepcopy(v, memo))
        return new

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")}
        return f"DistributedStrategy({fields})"
