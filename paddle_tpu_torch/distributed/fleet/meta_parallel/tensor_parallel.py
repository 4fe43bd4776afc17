"""TensorParallel (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``).

At wrap time the parameters are made alike where they should be: the
replicated ones (no ``split_axis``) from the first rank of the mp
group, and every parameter from the first rank of the dp group. Names and
state are the inner layer's (this rank's slices); ``full_state_dict()``
gives the reference's full layout (``bridge.full_state_dict``) and
``set_full_state_dict()`` slices one in.
"""
from ... import collective
from ...parallel import _LayerWrapper, broadcast_parameters
from .mp_layers import is_sliced


class TensorParallel(_LayerWrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        if collective._world() and hcg is not None:
            params = list(layers.parameters())
            broadcast_parameters(
                [p for p in params if not is_sliced(p)],
                hcg.get_model_parallel_group())
            broadcast_parameters(params, hcg.get_data_parallel_group())

    def full_state_dict(self):
        from ....bridge import full_state_dict
        return full_state_dict(self._layers)

    def set_full_state_dict(self, state):
        from ....bridge import load_reference_state
        return load_reference_state(self._layers, state)
