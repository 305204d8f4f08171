"""The transformer primitives (``linear``, ``layer_norm``, ``attention``,
``gelu``) in every arithmetic against plain torch, the ``table`` kind of
parameter, and a toy transformer topology found by its name
(``reference/arch_<arch>.py``)."""

import importlib
import os

import pytest
import torch
import torch.nn.functional as F

import weights
from reference import arch, counting, precision, training

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
TOY_MODEL = {"arch": "toyvit", "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
             "mlp_ratio": 4, "num_deconv_layers": 2, "num_deconv_filters": 16,
             "num_deconv_kernel": 4, "num_joints": 19}
BF16 = torch.bfloat16
SCORING = {"int8": lambda: precision.QuantizedScoring(127),
           "bf16": lambda: precision.RoundedScoring(),
           "fp8": lambda: precision.RoundedScoring(fp8=True)}
TRAINING = {"f32": lambda: precision.TrainingArithmetic(),
            "bf16": lambda: precision.TrainingArithmetic(BF16),
            "fp8": lambda: precision.TrainingArithmetic(fp8=True)}
EVERY = [("training", n) for n in sorted(TRAINING)] + [("scoring", n) for n in sorted(SCORING)]


def _ops(kind, name):
    return (TRAINING if kind == "training" else SCORING)[name]()


def _gen(seed=0):
    g = torch.Generator().manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=g)


def _params(**tensors):
    return arch.Params(tensors)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.fixture(scope="module", autouse=True)
def toy_topology():
    """The toy's topology file, found where ``arch.forward`` looks."""
    import reference

    reference.__path__.append(TOY)
    yield
    reference.__path__.remove(TOY)


# --------------------------------------------------------------------- linear

def _linear_case():
    r = _gen(1)
    x, w, b = r(3, 5, 24), r(40, 24) / 5, r(40) / 10
    return x, w, b, _params(**{"fc.weight": w, "fc.bias": b})


@pytest.mark.parametrize("name", sorted(TRAINING))
def test_training_linear_is_torchs(name):
    x, w, b, P = _linear_case()
    ops = TRAINING[name]()
    got = ops.linear(P, "fc", x, 24, 40)
    ref = F.linear(x, w, b)
    if name == "f32":
        assert torch.equal(got, ref)
    elif name == "bf16":
        assert torch.equal(got, F.linear(x.to(BF16), w.to(BF16), b.to(BF16)))
    else:
        assert 1e-3 < _rel(got, ref) < 0.2  # e4m3 operands: coarser than bf16, not wrong


@pytest.mark.parametrize("name", sorted(SCORING))
def test_scoring_linear_is_torchs(name):
    x, w, b, P = _linear_case()
    got = SCORING[name]().linear(P, "fc", x, 24, 40)
    assert got.dtype == BF16
    if name == "int8":
        sx = torch.amax(torch.abs(x)) / 127
        ws = torch.amax(torch.abs(w), dim=1) / 127
        xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int64)
        wq = torch.clamp(torch.round(w / ws[:, None]), -127, 127).to(torch.int64)
        ref = ((xq @ wq.t()).to(torch.float32) * (sx * ws) + b).to(BF16)
        assert torch.equal(got, ref)
    elif name == "bf16":
        ref = F.linear(x.to(BF16).float(), w.to(BF16).float(), b.to(BF16).float())
        assert torch.equal(got, ref.to(BF16))
    else:
        assert 1e-3 < _rel(got, F.linear(x, w, b)) < 0.2


def test_counter_linear_counts_products_and_bytes():
    x, w, b, _ = _linear_case()
    P = arch.Params()
    c = counting.MacCounter(itemsize=2)
    y = c.linear(P, "fc", x.to("meta"), 24, 40)
    assert tuple(y.shape) == (3, 5, 40)
    assert c.macs["linear"] == 15 * 24 * 40
    assert c.bytes["linear"] == 2 * (3 * 5 * 24 + 40 * 24 + 3 * 5 * 40 + 40)
    assert [(n, s, k) for n, s, k in P.spec] == [("fc.weight", (40, 24), "linear"),
                                                 ("fc.bias", (40,), "bias")]


# ----------------------------------------------------------------- layer norm

def _norm_case():
    r = _gen(2)
    x, g, b = r(2, 7, 32) * 3 + 1, 1 + r(32) / 10, r(32) / 10
    return x, g, b, _params(**{"ln.weight": g, "ln.bias": b})


@pytest.mark.parametrize("kind,name", EVERY)
def test_layer_norm_is_torchs(kind, name):
    x, g, b, P = _norm_case()
    ops = _ops(kind, name)
    if kind == "training":
        xin = x.to(BF16) if name == "bf16" else x
        got = ops.layer_norm(P, "ln", xin, 32)
        ref = F.layer_norm(xin.float(), (32,), g, b, 1e-6)
        assert got.dtype == xin.dtype
        tol = 1e-5 if got.dtype == torch.float32 else 1e-2
        assert _rel(got.float(), ref) < tol
    else:
        got = ops.layer_norm(P, "ln", x.to(BF16), 32)
        ref = F.layer_norm(x.to(BF16).float(), (32,), g, b, 1e-6)
        assert got.dtype == BF16 and _rel(got.float(), ref) < 4e-3


def test_counter_layer_norm_and_gelu_move_bytes_only():
    x, g, b, _ = _norm_case()
    c = counting.MacCounter(itemsize=4)
    y = c.gelu(c.layer_norm(arch.Params(), "ln", x.to("meta"), 32))
    assert tuple(y.shape) == (2, 7, 32) and set(c.macs) == {"conv", "deconv", "final"}
    assert c.bytes == {"layer_norm": 4 * (2 * 2 * 7 * 32 + 2 * 32), "gelu": 4 * 2 * 2 * 7 * 32}


# ------------------------------------------------------------------ attention

def _attention_case():
    r = _gen(3)
    return r(2, 9, 32), r(2, 9, 32), r(2, 9, 32)


def _sdpa(q, k, v, heads):
    split = lambda t: t.reshape(2, 9, heads, 32 // heads).transpose(1, 2)  # noqa: E731
    out = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(2, 9, 32)


@pytest.mark.parametrize("kind,name", EVERY)
def test_attention_is_torchs(kind, name):
    q, k, v = _attention_case()
    ref = _sdpa(q, k, v, 4)
    got = _ops(kind, name).attention(q, k, v, 4).float()
    if name == "f32":
        assert _rel(got, ref) < 1e-5
    elif name in ("bf16", "int8"):
        rounded = _sdpa(*(t.to(BF16).float() for t in (q, k, v)), 4)
        assert _rel(got, rounded) < 1e-2 and _rel(got, ref) < 2e-2
    else:
        assert 1e-2 < _rel(got, ref) < 0.3


def test_counter_attention_counts_both_products():
    q, k, v = (t.to("meta") for t in _attention_case())
    c = counting.MacCounter()
    c.attention(q, k, v, 4)
    assert c.macs["attention"] == 2 * 9 * 9 * 32
    assert c.bytes["attention"] == 2 * 4 * 2 * 9 * 32


# ------------------------------------------------------------------------ gelu

@pytest.mark.parametrize("kind,name", EVERY)
def test_gelu_is_erf_gelu(kind, name):
    x = _gen(4)(5, 16) * 3
    ops = _ops(kind, name)
    xin = x if kind == "training" and name != "bf16" else x.to(BF16)
    got = ops.gelu(xin)
    ref = F.gelu(xin.float(), approximate="none")
    if got.dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert torch.equal(got, ref.to(BF16)) or _rel(got.float(), ref) < 8e-3


# ------------------------------------------------------------- table, weights

def test_linear_and_table_weights_are_drawn_from_the_seed():
    spec = [("fc.weight", (256, 64), "linear"), ("pos", (1, 128, 64), "table"),
            ("fc.bias", (256,), "bias"), ("ln.weight", (64,), "weight")]
    a = weights.make_state_dict(spec, 7, "cpu")
    assert torch.equal(a["fc.weight"], weights.make_state_dict(spec, 7, "cpu")["fc.weight"])
    assert float(a["fc.weight"].std()) == pytest.approx(1 / 8, rel=0.05)
    assert float(a["pos"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(a["fc.bias"] == 0) and torch.all(a["ln.weight"] == 1)


# -------------------------------------------------------------- toy topology

def test_toy_topology_is_found_by_name_and_counted():
    assert arch.topology("toyvit").__module__ == "reference.arch_toyvit"
    macs = counting.forward_macs(TOY_MODEL, 64)
    tokens, d = 16, 32
    linear = tokens * (3 * 16 * 16 * d + 2 * (d * 3 * d + d * d + 2 * d * 4 * d))
    assert macs["linear"] == linear
    assert macs["attention"] == 2 * 2 * tokens * tokens * d
    assert macs["deconv"] == 16 * (d * 16 * 16 + 16 * 16 * 64)
    assert macs["final"] == 16 * 19 * 16 * 16


def test_toy_topology_matches_a_torch_module_and_trains():
    """In float32 the reference's toy forward equals the test's torch
    module of it (tests/toy/program_toyvit.py) on the same seeded weights;
    a training step gives every leaf, the table's too, a gradient."""
    import sys

    sys.path.insert(0, TOY)
    try:
        program_toyvit = importlib.import_module("program_toyvit")
    finally:
        sys.path.remove(TOY)
    _, spec = counting.trace_model(TOY_MODEL, 64)
    state = weights.make_state_dict(spec.spec, 11, "cpu")
    module = program_toyvit.ToyViT(TOY_MODEL, 64, dtype=torch.float32)
    module.load_state_dict(state, strict=True)
    x = _gen(5)(3, 3, 64, 64)
    with torch.no_grad():
        got = module.eval()(x)
        ref = arch.forward(TOY_MODEL, arch.Params(state), precision.RoundedScoring(), x)
    assert _rel(got, ref) < 0.05  # the reference in bf16 against the module in float32
    with torch.no_grad():
        exact = arch.forward(TOY_MODEL, arch.Params(state), _EvalF32(), x)
    assert _rel(got, exact) < 1e-5
    batch = {"x": x, "target": torch.rand(3, 19, 16, 16)}
    out = training.run_steps(TOY_MODEL, state, [batch], 1e-3, 1e9)
    trainable = [n for n, _, k in spec.spec if k in ("linear", "table", "conv", "head")]
    assert set(trainable) <= set(out["first_grad"])
    assert all(float(torch.linalg.vector_norm(out["first_grad"][n])) > 0 for n in trainable)


class _EvalF32(precision.TrainingArithmetic):
    """The training arithmetic in float32 with inference BatchNorm: the
    toy module's eval forward, term for term."""

    def _bn(self, x, gamma, beta):
        return x * (gamma / (1 + precision.BN_EPS) ** 0.5)[None, :, None, None] \
            + beta[None, :, None, None]


def test_rematerialized_training_steps_equal_the_plain_ones():
    """``run_steps(remat=True)``, which a multi-card cell's global batch
    needs, recomputes the same arithmetic: the same losses, gradients,
    parameters and statistics."""
    import harness

    model = harness.load_json(harness.HERE + "/configs/prn50-panoptic.json")["model"]
    model = dict(model, num_layers=18)
    _, spec = counting.trace_model(model, 64)
    state = weights.make_state_dict(spec.spec, 3, "cpu")
    r = _gen(6)
    batches = [{"x": r(4, 3, 64, 64), "target": torch.rand(4, 19, 16, 16)} for _ in range(2)]
    plain = training.run_steps(model, state, batches, 1e-3, 1e9)
    remat = training.run_steps(model, state, batches, 1e-3, 1e9, remat=True)
    assert plain["losses"] == remat["losses"]
    for key in ("first_grad", "params", "stats"):
        assert all(torch.equal(plain[key][n], remat[key][n]) for n in plain[key]), key
