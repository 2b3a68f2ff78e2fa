"""The conv epilogue (``ops/conv_epilogue.py``, ``csrc/conv_epilogue.cu``)
and the trunk's one helper for it (``models/resnet.py::bn_epilogue``).

On the CPU: the plain version's arithmetic (fp32, one rounding) against
float64 and against the chain of torch ops; whole bf16 forwards with every
epilogue through the wrapper's plain path (``applies`` granted to CPU
tensors: the stubbed launcher) against the chain; the wrapper's refusals;
which paths engage the epilogue, by the ``conv_epilogues`` and
``bn_passes`` counters.  Tests marked ``card`` hold the kernel against the
plain version on a CUDA card and skip without one.  This file imports no
JAX, so on the card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_epilogue.py -m card
"""

import pytest
import torch

from incremental_multimodal_medical_learning_ii_torch.models import resnet as tr
from incremental_multimodal_medical_learning_ii_torch.models.biovil_image import (
    biovil_image_forward,
    init_biovil_image_model,
    quantize_biovil_int8,
    space_to_depth_stem,
)
from incremental_multimodal_medical_learning_ii_torch.ops import conv_epilogue as ce
from incremental_multimodal_medical_learning_ii_torch.utils import profiling

BN_MODULES = 54  # ResNet-50: the stem's, 3 a block for 16 blocks, 4 downsample; the projector's
EPILOGUES = 50  # one a conv output: 1 + 3 x 16 in the trunk (downsample BNs merge), 1 projector
LAYER1_EPILOGUES = 9  # 3 blocks x 3, which K2's layer1 hook replaces
# two bf16 ResNet-50 forwards that round in different places, relative L2
# of their outputs; the fused one is held no further from fp32 than this
# share over the chain's own distance
FORWARD_REL = 2e-2
NO_WORSE = 1.25


def _random_bn_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Non-trivial frozen statistics in every batch norm (trained nets' ranges)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, tr.FrozenBatchNorm):
            c = m.scale.shape[0]
            m.scale.copy_(torch.rand(c, generator=g) * 0.5 + 0.5)
            m.bias.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
            m.mean.copy_((torch.rand(c, generator=g) - 0.5) * 0.2)
            m.var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


@pytest.fixture(scope="module")
def model():
    with torch.no_grad():
        return _random_bn_(init_biovil_image_model(torch.Generator().manual_seed(3)), 4)


@pytest.fixture(scope="module")
def images():
    return torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))


def _applies_on_cpu(monkeypatch):
    """``applies`` with the CPU in CUDA's place: the forwards then send every
    epilogue through the wrapper, whose CPU path is the plain version."""
    monkeypatch.setattr(ce, "applies", lambda a, residual=None: (
        not ce._needs_grad(a, residual) and ce._refusal(a, residual) is None))


def _nhwc(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(*shape, generator=g) * scale
    return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _params(c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(c, generator=g) + 0.5, (torch.rand(c, generator=g) - 0.5) * 0.2


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# ----------------------------------------------------------------------
# the arithmetic
# ----------------------------------------------------------------------
@pytest.mark.parametrize("residual,relu", [("none", True), ("identity", True), ("scaled", True),
                                           ("none", False), ("scaled", False)])
def test_reference_rounds_once(residual, relu):
    """fp32 products and sums, one rounding to bf16: within half a bf16 ulp
    of the float64 result, plus the fp32 roundings of the terms (which
    matter where they cancel), and nearer to it than the chain of torch ops
    (cast scale and shift, a rounding after each op) on average."""
    shape = (2, 32, 5, 7)
    a = _nhwc(shape, 1, 3.0)
    r = _nhwc(shape, 2, 3.0) if residual != "none" else None
    s, b = _params(32, 3)
    sr, br = _params(32, 4) if residual == "scaled" else (None, None)
    shift = b if br is None else b + br
    got = ce.conv_epilogue_reference(a, s, shift, r, sr, relu)
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)

    v = lambda t: t.double().view(1, -1, 1, 1)  # noqa: E731
    terms = [a.double() * v(s), v(b).expand_as(got)]
    if r is not None:
        terms += [r.double()] if sr is None else [r.double() * v(sr), v(br).expand_as(got)]
    exact = sum(terms)
    exact = torch.relu(exact) if relu else exact
    half_ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp(min=1e-30))) - 8)
    fp32 = 4 * 2.0 ** -24 * sum(t.abs() for t in terms)
    err = (got.double() - exact).abs()
    assert bool((err <= half_ulp + fp32).all())
    assert float((got.double() == exact.to(torch.bfloat16).double()).double().mean()) > 0.999

    bn = tr.FrozenBatchNorm(32)
    bn.scale.copy_(s)
    bn.bias.copy_(b)
    rbn = None
    if sr is not None:
        rbn = tr.FrozenBatchNorm(32)
        rbn.scale.copy_(sr)
        rbn.bias.copy_(br)
    chain = tr.bn_epilogue(a, bn, relu, r, rbn)
    assert float(err.mean()) < float((chain.double() - exact).abs().mean())


def test_bn_params_are_the_batch_norm_in_fp32_and_kept(model):
    """Scale and shift are FrozenBatchNorm's own formula without the casts;
    a downsample branch's shift merges into the block's; computed once,
    and again after a buffer changes."""
    block = model.encoder.layer2[0]
    bn, dbn = block.bn3, block.downsample_bn
    scale, shift, rscale = ce.bn_params(bn, dbn)
    s3, b3 = bn.affine()
    sd, bd = dbn.affine()
    assert scale.dtype == shift.dtype == rscale.dtype == torch.float32
    assert torch.equal(scale, s3) and torch.equal(rscale, sd) and torch.equal(shift, b3 + bd)
    root = torch.sqrt(bn.var + tr.BN_EPS)
    assert torch.equal(s3, bn.scale / root)
    assert torch.equal(b3, bn.bias - bn.mean * bn.scale / root)
    assert ce.bn_params(bn, dbn)[0] is scale  # kept with the module
    one = model.encoder.layer2[1].bn1
    before = ce.bn_params(one)
    assert before[2] is None and ce.bn_params(one)[0] is before[0]
    with torch.no_grad():
        one.var.mul_(2.0)
    after = ce.bn_params(one)
    try:
        assert after[0] is not before[0] and torch.equal(after[0], one.affine()[0])
    finally:
        with torch.no_grad():
            one.var.div_(2.0)


# ----------------------------------------------------------------------
# whole forwards: every epilogue through the wrapper against the chain
# ----------------------------------------------------------------------
def _forward(kind, model, images, dtype):
    with torch.no_grad():
        if kind == "biovil":
            return biovil_image_forward(model, images, dtype=dtype).projected_global_embedding
        if kind == "dilated":
            return tr.resnet50_forward(model.encoder, images, dtype=dtype,
                                       replace_stride_with_dilation=(False, False, True))
        if kind == "s2d":
            return biovil_image_forward(space_to_depth_stem(model), images,
                                        dtype=dtype).projected_global_embedding
        net = _random_bn_(tr.init_resnet18(torch.Generator().manual_seed(6)), 7)
        return tr.resnet18_forward(net, images, dtype=dtype)


@pytest.mark.parametrize("kind", ["biovil", "dilated", "s2d", "resnet18"])
def test_fused_forward_matches_the_chain(kind, model, images, monkeypatch):
    """A bf16 forward with each conv's epilogue in one fp32 pass (the plain
    version through the wrapper) against today's chain, within what two
    bf16 forwards differ by, and no further from the fp32 forward."""
    want32 = _forward(kind, model, images, torch.float32)
    chain = _forward(kind, model, images, torch.bfloat16)
    _applies_on_cpu(monkeypatch)
    with profiling.recording() as rec:
        fused = _forward(kind, model, images, torch.bfloat16)
    assert rec.counters.get("conv_epilogues", 0) > 0 and "bn_passes" not in rec.counters
    gap = _rel(fused.float(), chain.float())
    print(f"{kind}: fused vs chain {gap:.2e}; vs fp32: fused {_rel(fused.float(), want32):.2e}, "
          f"chain {_rel(chain.float(), want32):.2e}")
    assert 0 < gap < FORWARD_REL
    assert _rel(fused.float(), want32) <= NO_WORSE * _rel(chain.float(), want32)


@pytest.mark.parametrize("path,epilogues,bn_passes", [
    ("fused", EPILOGUES, 0),
    ("bf16-cpu", 0, BN_MODULES),
    ("fp32", 0, BN_MODULES),
    ("int8", 0, BN_MODULES),
    ("layer1_fn", EPILOGUES - LAYER1_EPILOGUES, 0),
])
def test_epilogue_engages_only_where_it_should(path, epilogues, bn_passes, model, images,
                                               monkeypatch):
    """A fused forward: one ``conv_epilogues`` a conv output (49 in the trunk,
    1 in the projector) and no ``FrozenBatchNorm.forward``.  The CPU (real
    ``applies``), fp32 and the int8 convs keep the chain, even where
    ``applies`` would take the tensor.  K2's layer1 hook takes layer1's nine
    epilogues with its convs; the stem, layers 2-4 and the projector fuse
    around it."""
    if path != "bf16-cpu":
        _applies_on_cpu(monkeypatch)
    net, kw = model, dict(dtype=torch.bfloat16)
    if path == "fp32":
        kw["dtype"] = torch.float32
    elif path == "int8":
        net, kw["int8"] = quantize_biovil_int8(model), True
    elif path == "layer1_fn":
        kw["fused_layer1"] = True
    with torch.no_grad(), profiling.recording() as rec:
        biovil_image_forward(net, images, **kw)
    assert rec.counters.get("conv_epilogues", 0) == epilogues
    assert rec.counters.get("bn_passes", 0) == bn_passes


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def test_wrapper_takes_the_plain_version_in_place_on_the_cpu():
    a = _nhwc((2, 64, 4, 4), 8)
    r = _nhwc((2, 64, 4, 4), 9)
    s, b = _params(64, 10)
    want = ce.conv_epilogue_reference(a, s, b, r, None, True)
    before = ce.conv_epilogue_.launches
    with profiling.recording() as rec:
        out = ce.conv_epilogue_(a, s, b, r)
    assert out is a and torch.equal(a, want)
    assert ce.conv_epilogue_.launches == before and rec.counters == {"conv_epilogues": 1}
    assert not ce.applies(a, r)  # the kernel's conditions name CUDA


def _misaligned():
    buf = torch.zeros(2 * 16 * 3 * 3 + 1, dtype=torch.bfloat16)
    return buf[1:].view(2, 3, 3, 16).permute(0, 3, 1, 2)  # channels_last, 2 bytes off


REFUSALS = {
    "float32": lambda: dict(a=_nhwc((1, 16, 3, 3), 0).float()),
    "nchw": lambda: dict(a=_nhwc((1, 16, 3, 3), 0).contiguous()),
    "channels-not-a-multiple-of-8": lambda: dict(a=_nhwc((1, 12, 3, 3), 0)),
    "too-many-channels": lambda: dict(a=_nhwc((1, 4096, 1, 2), 0)),
    "misaligned": lambda: dict(a=_misaligned()),
    "residual-shape": lambda: dict(residual=_nhwc((1, 16, 3, 4), 1)),
    "residual-layout": lambda: dict(residual=_nhwc((1, 16, 3, 3), 1).contiguous()),
    "scale-float64": lambda: dict(scale=torch.ones(16, dtype=torch.float64)),
    "shift-length": lambda: dict(shift=torch.zeros(8)),
    "residual-scale-alone": lambda: dict(residual_scale=torch.ones(16)),
    "meta": lambda: dict(a=torch.zeros(1, 16, 3, 3, dtype=torch.bfloat16, device="meta")
                         .contiguous(memory_format=torch.channels_last)),
    "grad": lambda: dict(a=_nhwc((1, 16, 3, 3), 0).requires_grad_()),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    kw = dict(a=_nhwc((1, 16, 3, 3), 0), scale=torch.ones(16), shift=torch.zeros(16))
    kw.update(REFUSALS[case]())
    with pytest.raises(RuntimeError if case == "grad" else ValueError,
                       match="backward" if case == "grad" else "conv_epilogue_"):
        ce.conv_epilogue_(**kw)
    if case not in ("scale-float64", "shift-length", "residual-scale-alone", "meta"):
        assert not ce.applies(kw["a"], kw.get("residual"))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def trunk_cases(model, images):
    """Every (C, H, W, residual, relu) the fused forward gives the epilogue,
    read from a forward with the wrapper spied (the wrapper counts its
    launches on the name its module holds: the spy's while it is there)."""
    seen = {}
    wrapped = ce.conv_epilogue_

    def spy(a, scale, shift, residual=None, residual_scale=None, relu=True):
        kind = "none" if residual is None else ("identity" if residual_scale is None else "scaled")
        seen.setdefault((a.shape[1], a.shape[2], a.shape[3], kind, relu), 0)
        seen[(a.shape[1], a.shape[2], a.shape[3], kind, relu)] += 1
        return wrapped(a, scale, shift, residual, residual_scale, relu)

    spy.launches = 0  # counted here while the spy is in place, and dropped
    ce.conv_epilogue_ = spy
    try:
        with torch.no_grad():
            biovil_image_forward(model, images, dtype=torch.bfloat16)
    finally:
        ce.conv_epilogue_ = wrapped
    return seen


@pytest.mark.card
def test_kernel_equals_the_plain_version_at_the_trunks_shapes(card):
    """Every case a 512^2 forward gives the kernel, at batch 2, bit for bit
    the plain version; the launches of one forward are 50."""
    model = _random_bn_(init_biovil_image_model(torch.Generator().manual_seed(3)), 4).to(card)
    images = torch.rand(2, 512, 512, 3, generator=torch.Generator().manual_seed(5)).to(card)
    cases = trunk_cases(model, images)
    ce.conv_epilogue_.launches = 0
    with torch.no_grad():
        biovil_image_forward(model, images, dtype=torch.bfloat16)
    assert ce.conv_epilogue_.launches == sum(cases.values()) == EPILOGUES
    for i, (c, h, w, kind, relu) in enumerate(sorted(cases)):
        a = _nhwc((2, c, h, w), i, 3.0).to(card)
        r = _nhwc((2, c, h, w), 100 + i, 3.0).to(card) if kind != "none" else None
        s, b = (t.to(card) for t in _params(c, 200 + i))
        sr = _params(c, 300 + i)[0].to(card) if kind == "scaled" else None
        want = ce.conv_epilogue_reference(a, s, b, r, sr, relu)
        got = ce.conv_epilogue_(a.clone(memory_format=torch.channels_last), s, b, r, sr, relu)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (c, h, w, kind, relu)


@pytest.mark.card
def test_fused_forward_on_the_card_matches_the_chain(card, monkeypatch):
    """A whole bf16 BioViL forward at 512^2 with the kernel against the
    chain of torch ops on the card, and both against fp32 (TF32 off)."""
    model = _random_bn_(init_biovil_image_model(torch.Generator().manual_seed(3)), 4).to(card)
    images = torch.rand(4, 512, 512, 3, generator=torch.Generator().manual_seed(5)).to(card)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want32 = _forward("biovil", model, images, torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    fused = _forward("biovil", model, images, torch.bfloat16)
    monkeypatch.setattr(ce, "applies", lambda a, residual=None: False)
    chain = _forward("biovil", model, images, torch.bfloat16)
    gap = _rel(fused.float(), chain.float())
    print(f"card: fused vs chain {gap:.2e}; vs fp32: fused {_rel(fused.float(), want32):.2e}, "
          f"chain {_rel(chain.float(), want32):.2e}")
    assert 0 < gap < FORWARD_REL
    assert _rel(fused.float(), want32) <= NO_WORSE * _rel(chain.float(), want32)
