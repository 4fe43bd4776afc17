"""The saved-model artifact on the CPU: the port's ``jit.save`` ->
``jit.load`` round trip (``paddle_tpu_torch/jit/export.py``) against the
port's eager forward and against the reference's ``jit.save`` ->
``jit.load``, with the reference's weights carried over by the bridge.

Models: a tiny GPT (vocab 256, hidden 128, 4 heads of 32, 2 layers, seq
1024: the flash gate's head dims, so attention takes the flash branch and
the exported program holds the forward operator), a tiny BERT pretraining
model (two outputs) and a two-head MLP.

Tolerances: the port's artifact against the port's eager forward,
bitwise (the program records the same ops on the same weights); against
the reference's artifact, float32 1e-4 (relative and absolute: on the CPU
the reference writes attention out with -1e9 masking, the port runs its
flash branch's plain version, ROADMAP queue 3 F3; logits are O(10)); a
fresh process serving the port's artifact, bitwise.
"""
import io
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as ref_nn
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.jit.io import load as ref_load
from paddle_tpu.jit.io import save as ref_save
from paddle_tpu.jit.to_static import InputSpec as RefInputSpec
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models.gpt import GPTConfig as RefGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu_torch import jit, nn
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.core import op_version
from paddle_tpu_torch.jit import export
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         synthetic_lm_batch)

ROOT = Path(__file__).resolve().parent.parent
SEQ = 1024
F32_TOL = 1e-4
GPT_TINY = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                max_seq_len=SEQ, hidden_dropout=0.0, attention_dropout=0.0)
BERT_SEQ = 16
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=32,
                 hidden_dropout=0.0, attention_dropout=0.0)
FLASH_OP = "paddle_tpu_torch.flash_attention_fwd"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _state(ref):
    return {n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()}


def _ref_out(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o.numpy()) for o in outs]


def _port_out(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o.detach().numpy() for o in outs]


class TwoHead(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 16, device="cpu")
        self.a = nn.Linear(16, 4, device="cpu")
        self.b = nn.Linear(16, 2, device="cpu")

    def forward(self, x):
        h = torch.tanh(self.fc(x))
        return self.a(h), self.b(h)


class RefTwoHead(ref_nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = ref_nn.Linear(8, 16)
        self.a = ref_nn.Linear(16, 4)
        self.b = ref_nn.Linear(16, 2)

    def forward(self, x):
        h = paddle.tanh(self.fc(x))
        return self.a(h), self.b(h)


def _gpt(seed=5):
    paddle.seed(seed)
    ref = RefGPT(RefGPTConfig(**GPT_TINY))
    ref.eval()
    port = load_reference_state(
        GPTForCausalLM(GPTConfig(**GPT_TINY), device="cpu"), _state(ref))
    ids = synthetic_lm_batch(5, SEQ, GPT_TINY["vocab_size"], seed=3)
    return ref, port.eval(), ids, [InputSpecs.gpt]


def _bert(seed=1):
    paddle.seed(seed)
    ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**BERT_TINY))
    ref.eval()
    port = load_reference_state(
        bert.BertForPretraining(bert.BertConfig(**BERT_TINY), device="cpu"),
        _state(ref))
    ids = np.random.RandomState(0).randint(
        0, BERT_TINY["vocab_size"], (5, BERT_SEQ)).astype("int32")
    return ref, port.eval(), ids, [InputSpecs.bert]


def _mlp(seed=13):
    paddle.seed(seed)
    ref = RefTwoHead()
    ref.eval()
    port = load_reference_state(TwoHead(), _state(ref))
    x = np.random.RandomState(6).randn(5, 8).astype("float32")
    return ref, port.eval(), x, [InputSpecs.mlp]


class InputSpecs:
    gpt = ([None, SEQ], "int32", "ids")
    bert = ([None, BERT_SEQ], "int32", "input_ids")
    mlp = ([None, 8], "float32", "x")


MODELS = {"gpt": _gpt, "bert": _bert, "mlp": _mlp}
N_OUTPUTS = {"gpt": 1, "bert": 2, "mlp": 2}


@pytest.fixture(scope="module", params=sorted(MODELS))
def saved(request, tmp_path_factory):
    """(name, reference model, port model, inputs, port prefix, reference
    prefix)."""
    ref, port, x, spec = MODELS[request.param]()
    root = tmp_path_factory.mktemp(request.param)
    prefix = str(root / "port")
    jit.save(port, prefix, input_spec=[jit.InputSpec(*s) for s in spec])
    ref_prefix = str(root / "ref")
    ref_save(ref, ref_prefix, input_spec=[RefInputSpec(*s) for s in spec])
    return request.param, ref, port, x, prefix, ref_prefix


def test_round_trip_is_bitwise_the_eager_forward(saved):
    name, _ref, port, x, prefix, _ = saved
    with torch.no_grad():
        want = _port_out(port(torch.from_numpy(x)))
    loaded = jit.load(prefix, device="cpu")
    got = _port_out(loaded(x))
    assert len(got) == len(want) == N_OUTPUTS[name]
    assert loaded.output_names == [f"output_{i}" for i in range(len(want))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_round_trip_matches_the_reference_artifact(saved):
    _name, _ref, _port, x, prefix, ref_prefix = saved
    want = _ref_out(ref_load(ref_prefix)(RefTensor(x)))
    got = _port_out(jit.load(prefix, device="cpu")(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("rows", [1, 3, 5])
def test_other_batch_sizes_serve_from_one_artifact(saved, rows):
    _name, _ref, port, x, prefix, _ = saved
    loaded = jit.load(prefix, device="cpu")
    with torch.no_grad():
        want = _port_out(port(torch.from_numpy(x[:rows])))
    got = _port_out(loaded(x[:rows]))
    for g, w in zip(got, want):
        assert g.shape[0] == rows
        np.testing.assert_array_equal(g, w)


def _program_of(prefix):
    with zipfile.ZipFile(prefix + ".pdmodel") as z:
        meta = json.loads(z.read("meta.json"))
        program = torch.export.load(io.BytesIO(z.read("program.pt2")))
    return meta, program


def test_gpt_program_holds_one_flash_node_per_layer(tmp_path):
    _ref, port, _ids, spec = _gpt()
    prefix = str(tmp_path / "gpt")
    jit.save(port, prefix, input_spec=spec)
    meta, program = _program_of(prefix)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum(FLASH_OP in t for t in targets) == GPT_TINY["num_layers"]
    assert meta["backend"] == "torch"
    assert meta["input_names"] == ["ids"]
    assert meta["input_specs"] == [{"shape": [None, SEQ],
                                    "dtype": "int32"}]
    assert meta["param_names"][0] == "gpt.wte.weight"
    # the weights live in .pdiparams only, in the meta's order
    params = np.load(prefix + ".pdiparams")
    assert len(params.files) == len(meta["param_names"])
    np.testing.assert_array_equal(
        params["p0"], port.gpt.wte.weight.detach().numpy())
    assert program.state_dict == {} and not program.constants


def test_bf16_parameters_round_trip_bitwise(tmp_path):
    _ref, port, ids, spec = _gpt()
    port = port.to(torch.bfloat16)
    prefix = str(tmp_path / "gpt16")
    jit.save(port, prefix, input_spec=spec)
    loaded = jit.load(prefix, device="cpu")
    assert all(p.dtype == torch.bfloat16
               for p in loaded.state_dict().values())
    with torch.no_grad():
        want = port(torch.from_numpy(ids[:2]))
    got = loaded(ids[:2])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


_CHILD = r"""
import json, sys
import numpy as np
from paddle_tpu_torch import inference
prefix, x_path, out_path = sys.argv[1:4]
cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
cfg.disable_gpu()
pred = inference.create_predictor(cfg)
pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(
    np.load(x_path))
outs = pred.run()
np.savez(out_path, *outs)
print(json.dumps(sorted(n for n in sys.modules
                        if n.startswith("paddle_tpu_torch.models")
                        or n.split(".")[0] in ("jax", "paddle_tpu")
                        or n.endswith("test_torch_jit_save"))))
"""


def test_fresh_process_serves_bitwise(saved, tmp_path):
    """A new interpreter that imports only the inference API (never the
    model's module, nor the reference) serves the artifact."""
    _name, _ref, port, x, prefix, _ = saved
    with torch.no_grad():
        want = _port_out(port(torch.from_numpy(x)))
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, prefix, str(tmp_path / "x.npy"),
         str(tmp_path / "out.npz")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    got = np.load(tmp_path / "out.npz")
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


def test_reference_artifact_is_refused_by_name(saved):
    _name, _ref, _port, _x, _prefix, ref_prefix = saved
    with pytest.raises(export.ForeignArtifactError, match="StableHLO"):
        jit.load(ref_prefix, device="cpu")


def test_pickle_path_round_trips(tmp_path):
    """Without input_spec, jit.save writes the same-codebase pickle, and
    jit.load restores the layer with its saved parameters."""
    from paddle_tpu_torch import nn as pnn
    torch.manual_seed(0)
    model = pnn.Sequential(pnn.Linear(4, 4, device="cpu"), pnn.ReLU())
    prefix = str(tmp_path / "leg")
    with pytest.warns(UserWarning, match="input_spec"):
        jit.save(model, prefix)
    assert not os.path.exists(prefix + ".pdmodel")
    saved_weight = model[0].weight.detach().clone()
    with torch.no_grad():
        model[0].weight.zero_()  # the pickle holds the saving-time values
    loaded = jit.load(prefix)
    assert isinstance(loaded, jit.TranslatedLayer)
    x = torch.ones(2, 4)
    with torch.no_grad():
        model[0].weight.copy_(saved_weight)
        want = model(x)
    assert torch.equal(loaded(x), want)


def test_newer_op_version_is_refused(tmp_path):
    """An artifact saved with a newer op definition than this runtime's
    is refused, naming the op; older ones load."""
    _ref, port, x, spec = _mlp()
    prefix = str(tmp_path / "m")
    jit.save(port, prefix, input_spec=spec)
    with zipfile.ZipFile(prefix + ".pdmodel") as z:
        files = {n: z.read(n) for n in z.namelist()}
    meta = json.loads(files["meta.json"])
    assert meta["op_versions"] == op_version.snapshot()
    meta["op_versions"]["dropout"] = op_version.get_op_version("dropout") + 1
    with zipfile.ZipFile(prefix + ".pdmodel", "w") as z:
        for n, b in files.items():
            z.writestr(n, json.dumps(meta) if n == "meta.json" else b)
    with pytest.raises(op_version.OpVersionError, match="dropout"):
        jit.load(prefix, device="cpu")
    meta["op_versions"] = {"dropout": 1}
    with zipfile.ZipFile(prefix + ".pdmodel", "w") as z:
        for n, b in files.items():
            z.writestr(n, json.dumps(meta) if n == "meta.json" else b)
    assert jit.load(prefix, device="cpu")(x)[0].shape == (5, 4)


def test_modes_restored_after_save(tmp_path):
    """jit.save exports the eval forward and restores each sublayer's
    own mode afterwards."""
    _ref, port, _x, spec = _mlp()
    port.train()
    port.a.eval()
    jit.save(port, str(tmp_path / "m"), input_spec=spec)
    assert port.training and port.fc.training and not port.a.training


def test_load_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legal")
    _ref, port, _x, spec = _mlp()
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        jit.save(port, os.path.join(tmp, "m"), input_spec=spec)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jit.load(os.path.join(tmp, "m"))
