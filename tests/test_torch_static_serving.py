"""Serving from a recorded Program on the CPU: ``build_serving_program``,
``serving_bf16_cast_pass``, ``Engine.from_program``, the inference model
of a Program (``static.save_inference_model`` -> ``load_inference_model``
-> ``Engine(path)``) and ``jit.TracedLayer``, held against
``paddle_tpu``'s on the same weights and ids.

A 2-layer GPT (hidden 32, seq 16, dropout 0) at ``bucket_ladder=(1,)``:
the reference records the batch as 1 and its reshapes keep it, so its
engine serves a Program at bucket 1 only (ROADMAP reference faults), and
the port's recorder keeps shapes the same way. Float32 logits within
1e-4 (the same math in another order; logits are O(1)); the bf16 pass
within a relative L2 of 2e-2 of the float32 program (measured ~4e-3),
and bitwise equal to ``Executor.run`` of the passed program.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.static as rstatic
from paddle_tpu import serving as ref_serving
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch import jit, serving
from paddle_tpu_torch.bridge import load_reference_state

CPU = "cpu"
F32_TOL = 1e-4
BF16_REL_L2 = 2e-2
GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=16, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def gpt_programs():
    from paddle_tpu.models.gpt import GPTConfig as RefCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ref.seed(9)
    rmodel = RefGPT(RefCfg(**GPT))
    rmodel.eval()
    state = {k: np.asarray(v.numpy()) for k, v in
             rmodel.state_dict().items()}
    pmodel = load_reference_state(GPTForCausalLM(GPTConfig(**GPT),
                                                 device=CPU), state).eval()
    out = []
    for st, model, dev in ((static, pmodel, {"device": CPU}),
                           (rstatic, rmodel, {})):
        prog = st.Program()
        with st.program_guard(prog):
            ids = st.data("ids", [None, 16], "int32", **dev)
            logits = model(ids)
        out.append((prog, logits))
    ids = np.random.RandomState(2).randint(0, 64, (1, 16)).astype(np.int32)
    return out, ids


@pytest.mark.parametrize("passes", [(), ("bf16",)])
def test_engine_from_program_matches_the_reference(gpt_programs, passes):
    (pprog, plog), (rprog, rlog) = gpt_programs[0]
    ids = gpt_programs[1]
    with serving.Engine.from_program(pprog, [plog], bucket_ladder=(1,),
                                     passes=passes) as eng:
        (got,) = eng.predict(ids)
    with ref_serving.Engine.from_program(rprog, [rlog], bucket_ladder=(1,),
                                         passes=passes) as eng:
        (want,) = eng.predict(ids)
    (f32,) = rstatic.Executor().run(rprog, feed={"ids": ids},
                                    fetch_list=[rlog])
    assert got.dtype == np.float32 and got.shape == want.shape
    if passes:
        assert _rel_l2(got, f32) <= BF16_REL_L2
        assert _rel_l2(want, f32) <= BF16_REL_L2
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_from_program_refuses_a_device(gpt_programs):
    """The program runs where its parameters are: a device= it would not
    honour is refused, not dropped."""
    (pprog, plog), _ = gpt_programs[0]
    with pytest.raises(TypeError, match="device"):
        serving.Engine.from_program(pprog, [plog], bucket_ladder=(1,),
                                    device="cpu")


def test_bf16_program_is_bitwise_its_executor_run(gpt_programs):
    (pprog, plog), _ = gpt_programs[0]
    ids = gpt_programs[1]
    built = serving.build_serving_program(pprog, [plog], passes=("bf16",))
    assert built.op_names()[0] == "cast" or "cast" not in built.op_names()
    assert all(t.dtype != torch.float32 for t in built.params.values())
    assert all(p.dtype == torch.float32 for p in pprog.params.values()
               if isinstance(p, torch.nn.Parameter))  # the live model stays
    (ex,) = static.Executor(CPU).run(built, feed={"ids": ids},
                                     fetch_list=[plog], return_numpy=False)
    with serving.Engine.from_program(pprog, [plog], bucket_ladder=(1,),
                                     passes=("bf16",)) as eng:
        (got,) = eng.predict(ids)
    assert ex.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, ex.float().numpy())


def test_bf16_pass_casts_float_feeds_first():
    prog = static.Program()
    lin = pt.nn.Linear(4, 2, device=CPU)
    with static.program_guard(prog):
        x = static.data("x", [None, 4], "float32", device=CPU)
        y = lin(x)
    p = static.apply_pass(prog, "serving_bf16_cast_pass")
    assert p.op_names() == ["cast"] + prog.op_names()
    feed = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    (got,) = static.Executor(CPU).run(p, feed={"x": feed}, fetch_list=[y],
                                      return_numpy=False)
    import copy
    with torch.no_grad():
        want = copy.deepcopy(lin).to(torch.bfloat16)(
            torch.from_numpy(feed).bfloat16())
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert lin.weight.dtype == torch.float32


def test_inference_model_round_trip_serves_buckets(tmp_path):
    """LeNet's eval Program saved as an inference model, loaded back and
    served at buckets 1 and 8: bitwise equal to ``Executor.run``."""
    from paddle_tpu_torch.vision.models import LeNet
    torch.manual_seed(0)
    net = LeNet(device=CPU).eval()
    prog = static.Program()
    with static.program_guard(prog):
        img = static.data("img", [None, 1, 28, 28], "float32", device=CPU)
        logits = net(img)
    exe = static.Executor(CPU)
    path = str(tmp_path / "lenet")
    static.save_inference_model(path, [img], [logits], exe, program=prog)
    layer, feeds, fetches = static.load_inference_model(path, exe)
    assert feeds == ["img"] and len(fetches) == 1
    x = np.random.RandomState(4).rand(8, 1, 28, 28).astype(np.float32)
    want = [exe.run(prog, feed={"img": x[:1]}, fetch_list=[logits])[0],
            exe.run(prog, feed={"img": x}, fetch_list=[logits])[0]]
    with serving.Engine(path, bucket_ladder=(1, 8), device=CPU) as eng:
        (one,) = eng.predict(x[:1])
        (eight,) = eng.predict(x)
    np.testing.assert_array_equal(one, want[0])
    np.testing.assert_array_equal(eight, want[1])
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  want[1])


def test_traced_layer(tmp_path):
    from paddle_tpu.jit import TracedLayer as RefTraced
    ref.seed(1)
    rlin = ref.nn.Linear(4, 3)
    plin = load_reference_state(pt.nn.Linear(4, 3, device=CPU), {
        k: np.asarray(v.numpy()) for k, v in rlin.state_dict().items()})

    class Two(pt.nn.Layer):
        def __init__(self, lin):
            super().__init__()
            self.lin = lin

        def forward(self, x, y):
            h = self.lin(x)
            return h + y, h * 2.0

    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    y = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    outs, traced = jit.TracedLayer.trace(Two(plin), [torch.from_numpy(x),
                                                    torch.from_numpy(y)])
    again = traced([torch.from_numpy(x), torch.from_numpy(y)])
    for a, b in zip(outs, again):
        assert torch.equal(a, b)
    rx = ref.to_tensor(x)
    want = rlin(rx).numpy()
    np.testing.assert_allclose(outs[1].detach().numpy(), want * 2.0,
                               rtol=1e-6)
    traced.set_strategy(None, None)
    path = str(tmp_path / "traced")
    traced.save_inference_model(path, feed=[0, 1], fetch=[1])
    served = jit.load(path, device=CPU)
    got = served(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), outs[1].detach().numpy())
    with pytest.raises(ValueError, match="fetch index"):
        traced.save_inference_model(path, fetch=[5])
    with pytest.raises(TypeError):
        jit.TracedLayer.trace(lambda t: t, [torch.from_numpy(x)])
    assert RefTraced is not None
