"""The port's stage 4 (domainrag_tpu_torch.stages.compose) end to end.

Parity: a toy 1-shot dataset (two annotated samples and one that only
the generate stage's results know, which takes the fallback path) with
two generated backgrounds per sample goes through the JAX package's
``process_dataset`` and the port's, on the JAX ``tiny_bundle(fill=True)``
weights (bridged) and the JAX noise for the same seeds. Both must write
the same file tree and the same JSON records (output roots and the run's
time stamps aside), masks and background copies bit for bit, and every
result image within 1 uint8 level (f32 on both sides; 1e-3 on the
[-1, 1] image can still cross a rounding edge).

Behaviour, on the port alone: the resolution policy (up, down,
conflict), bucket padding, ``max_rank_batch`` chunking and the fallback
inputs of a sample without annotations.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core import config as jconfig
from domainrag_tpu.core import imaging as jimaging
from domainrag_tpu.core.coco import write_coco as jwrite_coco
from domainrag_tpu.core.config import ComposeConfig as JComposeConfig
from domainrag_tpu.core.config import DatasetParams as JDatasetParams
from domainrag_tpu.core.config import ResolutionPolicy as JResolutionPolicy
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.stages import compose as jcompose
from domainrag_tpu_torch.core import config as tconfig
from domainrag_tpu_torch.core import imaging
from domainrag_tpu_torch.core.coco import write_coco
from domainrag_tpu_torch.core.config import (ComposeConfig, DatasetParams,
                                             ResolutionPolicy)
from domainrag_tpu_torch.core.log import StepTimer
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.stages import compose as tcompose
from test_torch_fill import port_bundle

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

DATASET = "UODD"
SHOT = 1


def _params(cls):
    return {DATASET: cls(strength=0.5, guidance_scale=4.0,
                         upscale_dimension=32)}


def _image(rng, w, h):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _toy_dataset(root, write):
    """datasets/UODD (two annotated samples) and the generate stage's
    results for them and for a third, result-only sample."""
    rng = np.random.default_rng(5)
    ds = root / "datasets" / DATASET
    (ds / "train").mkdir(parents=True)
    write(str(ds / "annotations" / f"{SHOT}_shot.json"),
          images=[{"id": 1, "file_name": "scallop_1.jpg",
                   "width": 40, "height": 36},
                  {"id": 2, "file_name": "seaurchin_2.jpg",
                   "width": 48, "height": 40}],
          annotations=[{"id": 1, "image_id": 1, "category_id": 1,
                        "bbox": [4, 4, 12, 10]},
                       {"id": 2, "image_id": 2, "category_id": 2,
                        "bbox": [8, 8, 16, 12]},
                       {"id": 3, "image_id": 2, "category_id": 2,
                        "bbox": [30, 20, 10, 10]}],
          categories=[{"id": 1, "name": "scallop"},
                      {"id": 2, "name": "seaurchin"}])
    for name, (w, h) in [("scallop_1", (40, 36)), ("seaurchin_2", (48, 40))]:
        _image(rng, w, h).save(ds / "train" / f"{name}.jpg")
    results = (root / "output" / "result" / f"{DATASET}_{SHOT}shot_retrieval"
               / "results_0")
    for sample in ("scallop_1", "seaurchin_2", "orphan_3"):
        (results / sample).mkdir(parents=True)
        for rank in (1, 2):
            _image(rng, 32, 32).save(
                results / sample / f"generated_image_rank{rank}.png")
    _image(rng, 24, 20).save(results / "orphan_3" / "target_input.png")
    return str(root / "datasets"), str(root / "output")


def _jax_noise(seeds, seq, c):
    return torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(int(s)), (seq, c), np.float32)))
        for s in seeds])


@pytest.fixture(scope="module")
def jax_bundle():
    return jfp.tiny_bundle(jax.random.PRNGKey(7), fill=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_bundle):
    """The same dataset through the JAX and the port process_dataset."""
    out = {}
    jcfg = JComposeConfig(resolution=JResolutionPolicy(max_dimension=64),
                          num_steps=4, dataset_params=_params(JDatasetParams))
    root = tmp_path_factory.mktemp("jax")
    datasets, output = _toy_dataset(root, jwrite_coco)
    result = jcompose.process_dataset(
        jcompose.ComposeStage(jax_bundle, jcfg, process_id="t", seed=0),
        DATASET, SHOT, datasets, output)
    out["jax"] = (output, result)

    cfg = ComposeConfig(resolution=ResolutionPolicy(max_dimension=64),
                        num_steps=4, dataset_params=_params(DatasetParams))
    root = tmp_path_factory.mktemp("port")
    datasets, output = _toy_dataset(root, write_coco)
    patch = pytest.MonkeyPatch()
    patch.setattr(tfp, "_noise", lambda bundle, seeds, seq, c:
                  _jax_noise(seeds, seq, c))
    try:
        timer = StepTimer()
        result = tcompose.process_dataset(
            tcompose.ComposeStage(port_bundle(jax_bundle), cfg,
                                  process_id="t", seed=0),
            DATASET, SHOT, datasets, output, timer=timer)
    finally:
        patch.undo()
    out["port"] = (output, result, timer)
    return out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _strip(obj, root):
    """A JSON record with its output root and time stamps taken out."""
    if isinstance(obj, dict):
        return {k: _strip(v, root) for k, v in obj.items()
                if k not in ("timestamp", "updated_at", "elapsed_s")}
    if isinstance(obj, list):
        return [_strip(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(root, "<out>")
    return obj


def test_compose_writes_the_jax_file_tree(runs):
    (jout, _), (tout, _, _) = runs["jax"], runs["port"]
    tree = _tree(tout)
    assert tree == _tree(jout)
    op = f"outpaint_hires/process_t/{DATASET}/{SHOT}_shot"
    for sample in ("scallop_1", "seaurchin_2", "orphan_3"):
        for rank in (1, 2):
            for part in ("mask", "hires_result", "final_result", "params"):
                ext = "json" if part == "params" else "png"
                assert (f"{op}/{sample}/{sample}_{part}_rank{rank}.{ext}"
                        in tree)
    assert f"{op}/outpaint_results_{SHOT}shot.json" in tree
    assert (f"final_results/process_t/{SHOT}_shot/{DATASET}/"
            f"scallop_1_final_result_rank1.png") in tree


def test_compose_json_matches_jax(runs):
    (jout, jres), (tout, tres, _) = runs["jax"], runs["port"]
    assert _strip(tres, tout) == _strip(jres, jout)
    assert [s["sample_id"] for s in tres["samples"]] == [
        "orphan_3", "scallop_1", "seaurchin_2"]
    for path in _tree(tout):
        if path.endswith(".json"):
            with open(os.path.join(tout, path)) as f, \
                    open(os.path.join(jout, path)) as g:
                assert _strip(json.load(f), tout) == \
                    _strip(json.load(g), jout), path


def test_compose_images_match_jax(runs):
    (jout, _), (tout, _, _) = runs["jax"], runs["port"]
    pngs = [p for p in _tree(tout) if p.endswith(".png")]
    assert len(pngs) > 20
    for path in pngs:
        got = np.asarray(Image.open(os.path.join(tout, path))).astype(int)
        want = np.asarray(Image.open(os.path.join(jout, path))).astype(int)
        assert got.shape == want.shape, path
        if "_mask_" in path or "_original" in path:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1, path


def test_compose_spans(runs):
    """Each of the 3 samples: one preparation, one prior (its inputs, the
    text towers and the image towers), one fill (its inputs, 2 encodes,
    2 steps (strength 0.5 of 4) and a decode), one save per
    background."""
    timer = runs["port"][2]
    assert timer.counts == {"prepare": 3, "prior": 3, "prior/inputs": 3,
                            "prior/text": 3, "prior/image": 3, "fill": 3,
                            "fill/inputs": 3, "encode": 6, "step": 6,
                            "decode": 3, "save": 6}


# ---------------------------------------------------------------------------
# the port's copies of the JAX package's host-side helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h", [(20, 24), (2000, 1000), (3000, 1200),
                                 (1500, 1500), (1000, 4000), (900, 3000)])
def test_resolution_policy_matches_jax(w, h):
    """Truth table of the policy (conflict included) and the resize, its
    inverse, bbox scaling and the /16 alignment."""
    try:
        want = jimaging.resolve_resolution(w, h, 1024, 2800)
    except jimaging.ResolutionConflictError:
        with pytest.raises(imaging.ResolutionConflictError):
            imaging.resolve_resolution(w, h, 1024, 2800)
        return
    got = imaging.resolve_resolution(w, h, 1024, 2800)
    assert got == want
    (nw, nh), up, down, was_up, was_down = got
    assert imaging.to_multiple_of(nw, 16, 64) == \
        jimaging.to_multiple_of(nw, 16, 64)
    boxes = [(3.5, 7.0, 40.2, 11.9), (0, 0, w, h)]
    factor = up if was_up else down
    assert imaging.scale_bboxes(boxes, factor) == \
        jimaging.scale_bboxes(boxes, factor)
    # the policy on a tenth-size image (window 102..280) and its inverse
    small = Image.new("RGB", (w // 10 + 1, h // 10 + 1))
    try:
        want_small = jimaging.apply_resolution(small, 102, 280)
    except jimaging.ResolutionConflictError:
        with pytest.raises(imaging.ResolutionConflictError):
            imaging.apply_resolution(small, 102, 280)
    else:
        got_small = imaging.apply_resolution(small, 102, 280)
        assert got_small[0].size == want_small[0].size
        assert got_small[1:] == want_small[1:]
    resized = Image.new("RGB", (nw, nh))
    assert imaging.restore_resolution(resized, up, down, was_up,
                                      was_down).size == \
        jimaging.restore_resolution(resized, up, down, was_up, was_down).size


def test_keep_mask_matches_jax():
    boxes = [(3, 4, 10, 6), (-2, 20, 8, 30), (28, 0, 9, 3), (5.7, 9.2, 0, 1)]
    np.testing.assert_array_equal(imaging.outpaint_keep_mask(32, 24, boxes),
                                  jimaging.outpaint_keep_mask(32, 24, boxes))


def test_dataset_params_match_jax():
    assert {k: dataclasses.asdict(v)
            for k, v in tconfig.DATASET_PARAMS.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.DATASET_PARAMS.items()}
    for name in ("uodd", "FISH", "unknown"):
        assert dataclasses.asdict(tconfig.get_dataset_params(
            name, {"UODD": 1536})) == dataclasses.asdict(
            jconfig.get_dataset_params(name, {"UODD": 1536}))
    for n in (1, 3):
        for i in range(n):
            assert tconfig.worker_slice(range(7), i, n) == \
                jconfig.worker_slice(range(7), i, n)


# ---------------------------------------------------------------------------
# behaviour (port only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle():
    return tfp.tiny_bundle(device="cpu", fill=True)


def _bgs(tmp_path, n, rng):
    paths = []
    for rank in range(1, n + 1):
        p = tmp_path / f"generated_image_rank{rank}.png"
        _image(rng, 32, 32).save(p)
        paths.append(str(p))
    return paths


def _stage(bundle, **kw):
    cfg = ComposeConfig(resolution=ResolutionPolicy(max_dimension=64),
                        num_steps=2, dataset_params=_params(DatasetParams),
                        **kw)
    return tcompose.ComposeStage(bundle, cfg, seed=0)


@pytest.mark.parametrize("size,processed,up,down", [
    ((24, 20), (36, 32), 1.6, 1.0),          # upscale the short side to 32
    ((80, 60), (64, 48), 1.0, 0.8),          # downscale the long side to 64
    ((40, 36), (40, 36), 1.0, 1.0)],         # inside the window
    ids=["up", "down", "kept"])
def test_resolution_policy(bundle, tmp_path, size, processed, up, down):
    rng = np.random.default_rng(1)
    log = _stage(bundle).process_sample(
        DATASET, SHOT, "s", _image(rng, *size), [(2, 3, 10, 8)], ["c"],
        _bgs(tmp_path, 1, rng), str(tmp_path / "out"))
    rec = log["outpainted_images"][0]
    params = rec["params"]
    assert (params["processed_resolution"]["width"],
            params["processed_resolution"]["height"]) == processed
    assert params["up_scale_factor"] == pytest.approx(up)
    assert params["down_scale_factor"] == pytest.approx(down)
    assert params["was_upscaled"] == (up > 1.0)
    assert params["was_downscaled"] == (down < 1.0)
    sx, sy = processed[0] / size[0], processed[1] / size[1]
    assert rec["bbox_coords_list"] == [[int(2 * sx), int(3 * sy),
                                        int(10 * sx), int(8 * sy)]]
    assert Image.open(rec["hires_result_path"]).size == processed
    assert Image.open(rec["final_result_path"]).size == size
    mask = np.asarray(Image.open(rec["mask_path"]))
    assert mask.shape == processed[::-1]
    assert set(np.unique(mask)) == {0, 255}
    with open(rec["params_path"]) as f:
        assert json.load(f) == params


def test_resolution_conflict_raises(bundle, tmp_path):
    rng = np.random.default_rng(2)
    with pytest.raises(imaging.ResolutionConflictError):
        _stage(bundle).process_sample(
            DATASET, SHOT, "s", _image(rng, 10, 80), [(0, 0, 4, 4)], ["c"],
            _bgs(tmp_path, 1, rng), str(tmp_path / "out"))


def test_bucket_padding_crops_back(bundle, tmp_path, monkeypatch):
    """The fill runs on the image padded to the bucket (padding
    keep-masked), and the results are cropped back to the aligned size."""
    shapes = []
    fill_float = tfp._fill_float

    def spy(bundle, image, mask, *args, **kw):
        shapes.append((tuple(image.shape), mask[:, 36:].max().item(),
                       mask[:, :, 40:].max().item()))
        return fill_float(bundle, image, mask, *args, **kw)

    monkeypatch.setattr(tfp, "_fill_float", spy)
    rng = np.random.default_rng(3)
    log = _stage(bundle, resolution_bucket=24).process_sample(
        DATASET, SHOT, "s", _image(rng, 40, 36), [(2, 3, 10, 8)], ["c"],
        _bgs(tmp_path, 1, rng), str(tmp_path / "out"))
    assert shapes == [((1, 48, 48, 3), 0, 0)]
    rec = log["outpainted_images"][0]
    assert Image.open(rec["hires_result_path"]).size == (40, 36)
    assert Image.open(rec["final_result_path"]).size == (40, 36)
    assert np.asarray(Image.open(rec["mask_path"])).shape == (48, 48)


def test_chunked_fill_matches_one_batch(bundle, tmp_path):
    rng = np.random.default_rng(4)
    original = _image(rng, 40, 36)
    bgs = _bgs(tmp_path, 3, rng)
    images = []
    for mb in (None, 2):
        log = _stage(bundle, max_rank_batch=mb).process_sample(
            DATASET, SHOT, "s", original, [(2, 3, 10, 8)], ["c"], bgs,
            str(tmp_path / f"out{mb}"))
        assert [r["params"]["bg_index"] for r in log["outpainted_images"]] \
            == [0, 1, 2]
        images.append([np.asarray(Image.open(r["hires_result_path"]))
                       .astype(int) for r in log["outpainted_images"]])
    for a, b in zip(*images):
        assert np.abs(a - b).max() <= 1


def test_fallback_without_annotations(tmp_path):
    """A sample only the generate stage knows: its target_input.png and
    the bbox crops placed on the reference's grid, else one centred
    bbox covering 30% of each side."""
    rng = np.random.default_rng(6)
    result_root = tmp_path / "result"
    sample = result_root / f"{DATASET}_{SHOT}shot_retrieval" / "results_0" \
        / "orphan"
    sample.mkdir(parents=True)
    _image(rng, 60, 48).save(sample / "target_input.png")
    assert tcompose.fallback_sample_inputs(
        DATASET, "nobody", str(result_root), SHOT) is None
    original, bboxes, cats = tcompose.fallback_sample_inputs(
        DATASET, "orphan", str(result_root), SHOT)
    assert original.size == (60, 48)
    assert bboxes == [(21, 17, 18, 14)] and cats == ["unknown"]
    crops = tmp_path / "crops" / DATASET
    crops.mkdir(parents=True)
    for i, (w, h) in enumerate([(10, 8), (12, 6)]):
        _image(rng, w, h).save(crops / f"orphan_{i}.png")
    _, bboxes, cats = tcompose.fallback_sample_inputs(
        DATASET, "orphan", str(result_root), SHOT, str(tmp_path / "crops"))
    assert bboxes == [(25, 20, 10, 8), (34, 21, 12, 6)]
    assert cats == ["unknown", "unknown"]


def test_rank_suffix_and_background_discovery(tmp_path):
    assert tcompose.rank_suffix("a/generated_image_rank3.png", 0) == "_rank3"
    assert tcompose.rank_suffix("a/generated_image.png", 1) == "_2"
    d = tmp_path / f"{DATASET}_{SHOT}shot_retrieval" / "results_2" / "s"
    d.mkdir(parents=True)
    for name in ("generated_image_rank2.png", "generated_image_rank1.png",
                 "target_input.png"):
        (d / name).write_bytes(b"")
    assert [os.path.basename(p) for p in tcompose.find_sample_backgrounds(
        str(tmp_path), DATASET, SHOT, "s")] == [
        "generated_image_rank1.png", "generated_image_rank2.png"]


def test_meshes_raise(bundle):
    """The stage takes the JAX stage's fields with JAX's defaults, meshes
    included; with a mesh it writes on the mesh's rank 0 (here the one
    process of a one-rank mesh)."""
    from domainrag_tpu_torch.parallel import mesh as tmesh
    cfg = ComposeConfig()
    names = [(f.name, f.default) for f in dataclasses.fields(
        tcompose.ComposeStage)]
    assert names == [(f.name, f.default) for f in dataclasses.fields(
        jcompose.ComposeStage)]
    one = tmesh.create_mesh()
    pipe = tmesh.Mesh(np.arange(1), ("pipe",))
    for kw in ({}, {"mesh": one}, {"pipe_mesh": pipe}):
        assert tcompose.ComposeStage(bundle, cfg, **kw).writes()
