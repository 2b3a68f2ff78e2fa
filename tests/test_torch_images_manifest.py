"""The port's data/images.py and data/manifest.py against the JAX
package's: image decoding and remapping, the CSV manifest without pandas
(against JAX's pandas manifest), the torch-free decode-worker import, and
the decode pool's start method."""

import csv
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from incremental_multimodal_medical_learning_ii_tpu.data import images as jimg
from incremental_multimodal_medical_learning_ii_tpu.data.manifest import (
    ChexpertManifest as JManifest,
)
from incremental_multimodal_medical_learning_ii_tpu.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)
from incremental_multimodal_medical_learning_ii_torch.data import images as timg
from incremental_multimodal_medical_learning_ii_torch.data.manifest import (
    ChexpertManifest as TManifest,
)
from incremental_multimodal_medical_learning_ii_torch.engine.extract import (
    manifest_image_iterator,
)

REPO = Path(__file__).resolve().parent.parent


# ----------------------------------------------------------------------
# images
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(4)
    gray = (rng.random((40, 30)) * 200 + 20).astype(np.uint8)
    rgb = (rng.random((24, 20, 3)) * 255).astype(np.uint8)
    files = {}
    Image.fromarray(gray, "L").save(d / "gray.png")
    files["png"] = d / "gray.png"
    Image.fromarray(gray, "L").save(d / "gray.jpg", quality=90)
    files["jpeg"] = d / "gray.jpg"
    Image.fromarray(rgb, "RGB").save(d / "rgb.png")
    files["rgb"] = d / "rgb.png"
    pal = Image.fromarray(rgb, "RGB").convert("P", palette=Image.ADAPTIVE, colors=16)
    pal.save(d / "palette.png")
    files["palette"] = d / "palette.png"
    gray16 = (rng.random((20, 16)) * 4000).astype(np.uint16)
    Image.fromarray(gray16).save(d / "gray16.png")
    files["16-bit"] = d / "gray16.png"
    return files


@pytest.mark.parametrize("kind", ["png", "jpeg", "rgb", "palette", "16-bit"])
@pytest.mark.parametrize("percentiles", [None, (2.0, 98.0)])
def test_load_image_matches_jax(image_files, kind, percentiles):
    ours = timg.load_image(image_files[kind], percentiles)
    ref = jimg.load_image(image_files[kind], percentiles)
    assert ours.dtype == ref.dtype == np.uint8 and ours.ndim == 2
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(timg.load_image_raw_uint8(image_files[kind]),
                                  jimg.load_image_raw_uint8(image_files[kind]))


def test_load_image_refusals_match_jax(tmp_path):
    for name in ("x.nii.gz", "x.dcm"):
        path = tmp_path / name
        path.write_bytes(b"")
        errors = []
        for mod in (timg, jimg):
            try:
                mod.load_image(path)
            except Exception as e:  # noqa: BLE001 - the two packages must raise alike
                errors.append((type(e), str(e)))
        assert len(errors) == 2 and errors[0] == errors[1], errors
    with pytest.raises(ValueError, match="not supported"):
        timg.load_image(tmp_path / "x.bmp")
    with pytest.raises(ValueError, match="ascending"):
        timg.remap_to_uint8(np.zeros((2, 2)), (50.0, 10.0))


def test_images_module_imports_no_torch():
    """data/images.py is what the decode workers import: it pulls in no
    torch (nor jax).  Run with -S so no sitecustomize pre-imports either."""
    code = (
        "import sys, site; "
        f"site.addsitedir({sysconfig.get_paths()['purelib']!r}); "
        f"sys.path.insert(0, {str(REPO)!r}); "
        "import incremental_multimodal_medical_learning_ii_torch.data.images; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib')]; "
        "assert not bad, bad; print('torch-free')"
    )
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "torch-free" in out.stdout


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------
LABELS = list(CHEXPERT_COMPETITION_TASKS)


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
        w.writerow(header)
        w.writerows(rows)


@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    """CheXpert-style CSVs: blank and NA-string cells, -1 labels, quoted
    paths with commas, with and without the view column."""
    d = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(9)
    na = ["", "NA", "N/A", "nan", "NaN", "null", "NULL", "None", "#N/A", "<NA>"]
    rows = []
    for i in range(40):
        view = "Frontal" if i % 3 else "Lateral"
        path = (f"CheXpert-v1.0-small/train/patient{i:05d}/study1/view1_{view.lower()}.jpg"
                if i % 7 else f"dir, with comma/p{i}_{view.lower()}.jpg")
        labels = []
        for j in range(5):
            r = rng.random()
            labels.append(na[(i + j) % len(na)] if r < 0.15 else
                          ("-1.0" if r < 0.3 else ("1.0" if r < 0.6 else ("0" if r < 0.8 else "0.0"))))
        rows.append([path, "Female" if i % 2 else "Male", str(50 + i), view, "AP", *labels])
    rows.append(["p_last_frontal.jpg", "Male", "70", "Frontal", "PA", "1", "0", "0", "0", "0"])
    rows.append(["p_neg_frontal.jpg", "Male", "71", "Frontal", "PA", "0", "0", "0", "0", "0"])
    header = ["Path", "Sex", "Age", "Frontal/Lateral", "AP/PA", *LABELS]
    _write_csv(d / "with_view.csv", header, rows)
    _write_csv(d / "no_view.csv", [h for h in header if h != "Frontal/Lateral"],
               [r[:3] + r[4:] for r in rows])
    return {"with_view": d / "with_view.csv", "no_view": d / "no_view.csv"}


def _same(ours: TManifest, ref: JManifest):
    assert len(ours) == len(ref)
    assert ours.image_paths() == ref.image_paths()
    assert all(ours.image_path(i) == ref.image_path(i) for i in range(len(ref)))
    np.testing.assert_array_equal(ours.labels(), ref.labels())  # NaN where NaN
    assert ours.labels().dtype == np.float32


@pytest.mark.parametrize("which", ["with_view", "no_view"])
def test_manifest_matches_pandas_manifest(csv_files, which):
    kw = dict(img_dir="/data/")
    ours, ref = TManifest.from_csv(csv_files[which], **kw), JManifest.from_csv(csv_files[which], **kw)
    _same(ours, ref)
    assert np.isnan(ours.labels()).any() and (ours.labels() == -1).any()
    _same(ours.filter_frontal(), ref.filter_frontal())
    _same(ours.dropna_labels(), ref.dropna_labels())
    _same(ours.remove_all_negative(), ref.remove_all_negative())
    _same(ours.dropna_labels().filter_frontal().remove_all_negative(),
          ref.dropna_labels().filter_frontal().remove_all_negative())
    for a, b in zip(ours.split(15), ref.split(15)):
        _same(a, b)
    np.testing.assert_array_equal(ours.positive_counts(), ref.positive_counts())
    clean_t, clean_j = ours.dropna_labels(), ref.dropna_labels()
    assert clean_t.label_pattern_counts() == clean_j.label_pattern_counts()
    with pytest.raises(ValueError):  # a NaN label has no pattern, in either package
        ours.label_pattern_counts()


def test_manifest_missing_label_column_raises(tmp_path):
    _write_csv(tmp_path / "m.csv", ["Path", "Atelectasis"], [["a.jpg", "1"]])
    with pytest.raises(KeyError):
        TManifest.from_csv(tmp_path / "m.csv").labels()
    with pytest.raises(KeyError):
        JManifest.from_csv(tmp_path / "m.csv").labels()


# ----------------------------------------------------------------------
# the decode iterator and its pool
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def image_manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    rng = np.random.default_rng(2)
    rows = []
    for i in range(5):
        name = f"img_{i}.png"
        Image.fromarray((rng.random((40 + i, 30)) * 255).astype(np.uint8), "L").save(d / name)
        rows.append([name, i % 2, 0, 1, 0, 1])
    _write_csv(d / "labels.csv", ["Path", *LABELS], rows)
    return TManifest.from_csv(d / "labels.csv", img_dir=str(d) + "/")


def test_manifest_iteration_and_pool(image_manifest, monkeypatch):
    """Serial, pooled and offset iteration agree; the pool never forks (a
    forked child would inherit torch's and CUDA's state mid-use)."""
    import multiprocessing

    items = list(manifest_image_iterator(image_manifest))
    assert [im.shape for im, _ in items] == [(40 + i, 30) for i in range(5)]
    np.testing.assert_array_equal(items[1][1], [1, 0, 1, 0, 1])
    seen = []
    real_get_context = multiprocessing.get_context

    def recording_get_context(method=None):
        seen.append(method)
        return real_get_context(method)

    monkeypatch.setattr(multiprocessing, "get_context", recording_get_context)
    pooled = list(manifest_image_iterator(image_manifest, workers=2))
    assert seen and all(m in ("forkserver", "spawn") for m in seen), seen
    for (a, la), (b, lb) in zip(items, pooled, strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    tail = list(manifest_image_iterator(image_manifest, start=3))
    assert len(tail) == 2
    np.testing.assert_array_equal(tail[0][0], items[3][0])


@pytest.mark.parametrize("workers", [0, 2])
def test_manifest_iteration_decodes_only_kept_positions(image_manifest, workers):
    """Positions ``keep`` refuses are not decoded: zeros of the file's size
    stand in for them, in order, serially and through the pool."""
    items = list(manifest_image_iterator(image_manifest))
    kept = list(manifest_image_iterator(image_manifest, workers=workers, start=1,
                                        keep=lambda j: j % 2 == 1))
    assert len(kept) == 4
    for j, ((img, lbl), (want, want_lbl)) in enumerate(zip(kept, items[1:], strict=True)):
        np.testing.assert_array_equal(lbl, want_lbl)
        if j % 2 == 1:
            np.testing.assert_array_equal(img, want)
        else:
            assert img.shape == want.shape and img.dtype == np.uint8 and not img.any()
