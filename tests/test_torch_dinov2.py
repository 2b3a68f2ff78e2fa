"""The port's DINOv2 tower (``models/dinov2.py``) against the plain float32
forward in ``tests/plain_dinov2.py`` on seeded random weights, on the CPU
at small sizes; the grayscale fold; the tower through
``engine/extract.py::extract_embeddings`` (shards, resume, two gloo ranks)
and ``cli/extract_embeddings.py --image-model``; the checkpoint loader; the
tower's span and counters."""

import numpy as np
import pytest
import torch

from incremental_multimodal_medical_learning_ii_torch.cli import extract_embeddings as cli
from incremental_multimodal_medical_learning_ii_torch.data.store import ShardedEmbeddingStore
from incremental_multimodal_medical_learning_ii_torch.engine import extract as ex
from incremental_multimodal_medical_learning_ii_torch.models import dinov2 as vit
from incremental_multimodal_medical_learning_ii_torch.ops.preprocess import (
    SharedSizePreprocessPlan,
    preprocess_device_shared,
)
from incremental_multimodal_medical_learning_ii_torch.parallel.mesh import spawn_ranks
from incremental_multimodal_medical_learning_ii_torch.utils.profiling import recording

import plain_dinov2
from torch_port_helpers import dinov2_extract_on_rank, one_torch_thread  # noqa: F401

# fp32 against fp32: the same sums in another order (conv2d against the
# patch GEMM, the plain softmax against K3's plain version), so rounding
# alone, a few ulps of the O(1) outputs
FP32_ATOL = 2e-5
# bf16 rounds every block GEMM's inputs and the residual stream to 8
# significant bits (2^-9 relative each); over two blocks the pooled
# embedding's relative L2 gap reads 0.004-0.006, and 0.02 leaves 3x room
BF16_REL = 0.02
# the published width at one block: 3,072-wide shards on the CPU
WIDE = vit.tiny_dinov2_dims(hidden_size=1536, num_heads=24, ffn_hidden=4096, depth=1)


def _weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _pixels(n, seed, s=56):
    """(n, s, s) grey pixels in [0, 1] on the uint8 grid, as the device preprocess gives them."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, (n, s, s)) / 255.0, dtype=torch.float32)


def _plain(model, pixels):
    d = model.dims
    return plain_dinov2.forward(_weights(model), plain_dinov2.normalize(pixels), depth=d.depth,
                                heads=d.num_heads, registers=d.num_registers, ffn=d.ffn,
                                eps=d.ln_eps)


def _rel(a, b):
    return float((torch.linalg.vector_norm(a - b, dim=1) / torch.linalg.vector_norm(b, dim=1)).max())


@pytest.mark.parametrize("registers", [0, 4])
@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_tower_matches_the_plain_forward(ffn, registers):
    dims = vit.tiny_dinov2_dims(ffn=ffn, num_registers=registers,
                                ffn_hidden=96 if ffn == "swiglu" else 256)
    model = vit.init_dinov2(dims, torch.Generator().manual_seed(7))
    pixels = _pixels(3, 1)
    want = _plain(model, pixels)
    rgb = pixels[..., None].expand(-1, -1, -1, 3)
    got = vit.dinov2_forward(model, rgb)
    assert got.shape == (3, 2 * dims.hidden_size) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=FP32_ATOL, rtol=0)
    assert _rel(vit.dinov2_forward(model, rgb, dtype=torch.bfloat16), want) < BF16_REL
    # the pooled output tells images apart: a tower that ignored its input would not
    assert _rel(want[:1], want[1:2]) > 0.05


def test_cast_blocks_once_keeps_the_bf16_forward():
    """The blocks cast to bf16 once give the forward that casts each weight
    per call, bit for bit; the tokens and the patch embedding stay fp32 and
    shared; the original tower is left in fp32."""
    model = vit.init_dinov2(vit.tiny_dinov2_dims(), torch.Generator().manual_seed(9))
    cast = vit.cast_dinov2_blocks(model, torch.bfloat16)
    assert {p.dtype for p in cast.blocks.parameters()} == {cast.norm.weight.dtype} == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert cast.pos_embed is model.pos_embed and cast.patch_embed is model.patch_embed
    assert vit.cast_dinov2_blocks(cast, torch.bfloat16) is cast
    rgb = _pixels(2, 3)[..., None].expand(-1, -1, -1, 3)
    assert torch.equal(vit.dinov2_forward(cast, rgb, dtype=torch.bfloat16),
                       vit.dinov2_forward(model, rgb, dtype=torch.bfloat16))


def test_fold_equals_the_normalised_three_channels():
    model = vit.init_dinov2(vit.tiny_dinov2_dims(), torch.Generator().manual_seed(8))
    folded = vit.fold_grayscale_patch_embed(model)
    assert folded.patch_embed.proj.weight.shape[1] == 1
    assert model.patch_embed.proj.weight.shape[1] == 3  # the original is left as it was
    assert folded.blocks is model.blocks  # shared, not copied
    assert vit.fold_grayscale_patch_embed(folded) is folded
    pixels = _pixels(2, 2)
    torch.testing.assert_close(vit.dinov2_forward(folded, pixels[..., None]), _plain(model, pixels),
                               atol=FP32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="takes 1 channel"):
        vit.dinov2_forward(folded, pixels[..., None].expand(-1, -1, -1, 3))
    with pytest.raises(ValueError, match="56"):
        vit.dinov2_forward(folded, _pixels(1, 3, s=42)[..., None])


def test_published_widths():
    d = vit.dinov2_vitg14_reg()
    assert (d.hidden_size, d.depth, d.num_heads, d.head_dim, d.ffn, d.ffn_hidden) == (
        1536, 40, 24, 64, "swiglu", 4096)
    assert (d.grid, d.num_tokens, d.embed_dim, d.num_registers, d.ln_eps) == (37, 1374, 3072, 4, 1e-6)


def _images(n, seed=5, hw=(70, 60)):
    rng = np.random.default_rng(seed)
    return [((rng.random(hw) * 255).astype(np.uint8), (rng.random(5) < 0.5).astype(np.float32))
            for _ in range(n)]


KW = dict(batch_size=2, size=56, crop=56, dtype=torch.float32, device="cpu", checkpoint_interval=2)


@pytest.fixture(scope="module")
def wide():
    return vit.init_dinov2(WIDE, torch.Generator().manual_seed(9))


def test_extract_shards_and_resume(wide, tmp_path):
    imgs = _images(5)
    clean = ex.extract_embeddings(iter(imgs), wide, store=ShardedEmbeddingStore(tmp_path / "clean"),
                                  **KW)
    assert clean.embeddings.shape == (5, 3072)
    shards = ShardedEmbeddingStore(tmp_path / "clean")
    np.testing.assert_array_equal(shards.glue().embeddings, clean.embeddings)
    assert all(np.load(p)["embeddings"].shape[1] == 3072 for p in shards.shard_paths())
    # the rows are the tower's forward of the device preprocess's pixels
    plan = SharedSizePreprocessPlan(70, 60, size=56, crop=56)
    raw = torch.as_tensor(plan.prepare([im for im, _ in imgs]))
    pixels = preprocess_device_shared(raw, torch.as_tensor(plan.w_h), torch.as_tensor(plan.w_w),
                                      channels=3)
    np.testing.assert_allclose(clean.embeddings, vit.dinov2_forward(wide, pixels).numpy(),
                               atol=FP32_ATOL)
    cut = ShardedEmbeddingStore(tmp_path / "cut")
    ex.extract_embeddings(iter(imgs[:2]), wide, store=cut, **KW)
    resumed = ex.extract_embeddings(iter(imgs), wide, store=cut, resume=True, **KW)
    np.testing.assert_array_equal(resumed.embeddings, clean.embeddings)
    bf16 = ex.extract_embeddings(iter(imgs), wide, **{**KW, "dtype": torch.bfloat16})
    assert _rel(torch.as_tensor(bf16.embeddings), torch.as_tensor(clean.embeddings)) < BF16_REL


def test_extract_refusals(wide):
    with pytest.raises(ValueError, match="dinov2 tower has no int8"):
        ex.extract_embeddings(iter(_images(2)), wide, int8=True, **KW)
    with pytest.raises(ValueError, match="takes 56x56 crops"):  # before any image is drawn
        ex.extract_embeddings(iter(()), wide, **{**KW, "size": 64, "crop": 64})
    assert ex.image_tower(wide).width == 3072 and ex.image_tower(object()) is ex.BIOVIL_TOWER


def test_extract_on_two_gloo_ranks(tmp_path):
    imgs = _images(4, seed=6)
    kw = dict(KW, batch_size=4, checkpoint_interval=4)
    dims = vit.tiny_dinov2_dims()
    ranks = spawn_ranks(dinov2_extract_on_rank, 2, "cpu", dims, imgs, kw, str(tmp_path))
    want = ex.extract_embeddings(iter(imgs), vit.init_dinov2(dims, torch.Generator().manual_seed(3)),
                                 **kw).embeddings
    for rank in ranks:
        np.testing.assert_allclose(rank["plain"], want, atol=1e-5)
        np.testing.assert_array_equal(rank["rows"], ranks[0]["plain"])


def test_counters_of_one_batch(wide):
    with recording() as rec:
        ex.extract_embeddings(iter(_images(2)), wide, **KW)
    assert len(rec.named("vit-encode")) == 1
    (encode,) = rec.named("extract-encode")
    (vit_span,) = rec.named("vit-encode")
    assert vit_span.parent_id == encode.span_id
    c = rec.counters
    assert (c["vit_images"], c["vit_tokens"], c["vit_attention_launches"]) == (
        2, 2 * WIDE.num_tokens, WIDE.depth)


def test_cli_image_model_flag(tmp_path, monkeypatch):
    dims = vit.tiny_dinov2_dims()
    monkeypatch.setattr(vit, "dinov2_vitg14_reg", lambda: dims)
    out = cli.main(["--image-model", "dinov2-vitg14-reg", "--synthetic", "3", "--batch-size", "2",
                    "--checkpoint-interval", "2", "--fp32", "--device", "cpu",
                    "--out-dir", str(tmp_path)])
    assert out["dataset"].embeddings.shape == (3, dims.embed_dim) and out["shards"] == 2
    model = vit.init_dinov2(dims, torch.Generator().manual_seed(0))
    want = ex.extract_embeddings(cli.synthetic_images(3), model, **{**KW, "size": dims.image_size})
    np.testing.assert_array_equal(out["dataset"].embeddings, want.embeddings)
    with pytest.raises(SystemExit, match="--dinov2-checkpoint"):
        cli.main(["--image-model", "dinov2-vitg14-reg", "--csv", "x.csv", "--device", "cpu",
                  "--out-dir", str(tmp_path)])


def test_loader_takes_the_public_names(tmp_path):
    dims = vit.tiny_dinov2_dims()
    model = vit.init_dinov2(dims, torch.Generator().manual_seed(4))
    state = _weights(model)
    assert {"cls_token", "register_tokens", "pos_embed", "patch_embed.proj.weight",
            "blocks.1.attn.qkv.bias", "blocks.0.ls1.gamma", "blocks.0.mlp.w12.weight",
            "blocks.0.mlp.w3.bias", "blocks.1.ls2.gamma", "norm.weight"} <= set(state)
    state["mask_token"] = torch.zeros(1, dims.hidden_size)  # pre-training only: dropped
    path = tmp_path / "dinov2_reg.pth"
    torch.save(state, path)
    loaded = vit.load_dinov2_checkpoint(path, dims)
    pixels = _pixels(2, 4)[..., None].expand(-1, -1, -1, 3)
    torch.testing.assert_close(vit.dinov2_forward(loaded, pixels), vit.dinov2_forward(model, pixels),
                               atol=0, rtol=0)
    state["blocks.0.ls1.weight"] = state.pop("blocks.0.ls1.gamma")
    with pytest.raises(RuntimeError, match="ls1"):
        vit.load_dinov2_state_dict(state, dims)
