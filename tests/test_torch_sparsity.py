"""``sparsity`` in the port against ``paddle_tpu.sparsity``:
``create_mask`` (the ``mask_1d`` greedy search), ``check_mask_1d``,
``check_sparsity``, ``calculate_density`` and ``prune_model``, on random
weights, on weights with tied magnitudes (the same numpy search decides
the ties on both sides) and on a last axis that is not a multiple of 4.
Masks and pruned weights are compared exactly; the port's masks are
tensors on the parameter's device, and ``reapply_masks`` works in place.
"""
import numpy as np
import pytest
import torch

CASES = {
    "random": lambda rng: rng.randn(6, 8).astype("float32"),
    "tied": lambda rng: np.round(rng.randn(5, 12) * 2).astype("float32"),
    "ragged": lambda rng: rng.randn(3, 4, 10).astype("float32"),
    "all_equal": lambda rng: np.ones((4, 8), "float32"),
}


@pytest.mark.parametrize("nm", [(2, 4), (1, 4)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_masks_and_checks_match_the_reference(case, nm):
    import paddle_tpu.sparsity as ref
    import paddle_tpu_torch.sparsity as port
    n, m = nm
    w = CASES[case](np.random.RandomState(3))
    want = ref.create_mask(w, n=n, m=m)
    for arg in (w, torch.from_numpy(w)):
        got = port.create_mask(arg, n=n, m=m)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for x in (w, w * want):
        assert port.check_mask_1d(x, n, m) == ref.check_mask_1d(x, n, m)
        assert port.check_sparsity(torch.from_numpy(x), n=n, m=m) == \
            ref.check_sparsity(x, n=n, m=m)
        assert port.calculate_density(torch.from_numpy(x)) == \
            ref.calculate_density(x)
    assert port.check_mask_1d(w * want, n, m)


def test_prune_model_matches_the_reference():
    import paddle_tpu as paddle
    import paddle_tpu.sparsity as ref
    import paddle_tpu_torch.sparsity as port
    from paddle_tpu_torch import nn
    rng = np.random.RandomState(5)
    weights = {"0.weight": rng.randn(8, 12).astype("float32"),
               "0.bias": rng.randn(12).astype("float32"),
               "2.weight": rng.randn(12, 4).astype("float32"),
               "2.bias": rng.randn(4).astype("float32")}
    r = paddle.nn.Sequential(paddle.nn.Linear(8, 12), paddle.nn.ReLU(),
                             paddle.nn.Linear(12, 4))
    for k, v in weights.items():
        r.state_dict()[k].set_value(v)
    p = nn.Sequential(nn.Linear(8, 12, device="cpu"), nn.ReLU(),
                      nn.Linear(12, 4, device="cpu"))
    with torch.no_grad():
        for k, t in p.named_parameters():
            t.copy_(torch.from_numpy(weights[k]))
    ref.prune_model(r)
    masks = port.prune_model(p)
    assert len(masks) == 2  # the weights; biases are skipped
    for k, t in p.named_parameters():
        assert np.array_equal(t.detach().numpy(),
                              np.asarray(r.state_dict()[k]._value)), k
    with torch.no_grad():
        p[0].weight.add_(1.0)
    port.ASPHelper.reapply_masks(list(p.parameters()))
    assert port.check_sparsity(p[0].weight)
    assert isinstance(next(iter(masks.values())), torch.Tensor)
