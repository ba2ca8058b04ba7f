"""Stage 2 of the port (retrieval) against the JAX package's, on the same
numpy inputs and bridged weights, on the CPU.

Limits, each with its reason:
- ``clip_preprocess`` / ``style_preprocess``: bitwise (both resize with
  PIL's resampler, or the JAX package's native one proven byte-equal to it).
- ``encode_image`` (f32): 1e-5 in relative norm; ``style_features``,
  ``batchnorm``, ``max_pool``: 1e-5 / 1e-6 absolute (summation order only).
- top-k: indices and scores bitwise on integer-valued banks (every inner
  product is exact in f32 under any order), on the FAISS fixture and on
  tie-heavy banks (the order is the total order (score desc, index asc)).
- ``run_retrieval``: the same file tree, JSON keys, image order and ranks;
  similarities and cached features within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core import imaging as jimaging
from domainrag_tpu.models import clip as jclip
from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import resnet_stem as jstem
from domainrag_tpu.ops import topk as jtopk
from domainrag_tpu.stages import encoders as jenc
from domainrag_tpu.stages import retrieve as jret
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import imaging as timaging
from domainrag_tpu_torch.models import clip as tclip
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import resnet_stem as tstem
from domainrag_tpu_torch.ops import topk as ttopk
from domainrag_tpu_torch.stages import encoders as tenc
from domainrag_tpu_torch.stages import retrieve as tret

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "faiss_topk_fixture.npz")
# patch 32 and head_dim 64, ViT-B/32's shapes at a small width
PATCH32 = jclip.ClipVisionConfig(image_size=64, patch_size=32, hidden=128,
                                 layers=2, heads=2, projection_dim=32)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _tree(jax_tree):
    return bridge.params(jax.tree.map(np.asarray, jax_tree), device="cpu")


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def _image(mode, size, seed):
    rng = np.random.default_rng(seed)
    w, h = size
    chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 256, (h, w, chans), dtype=np.uint8)
    return Image.fromarray(arr[..., 0] if chans == 1 else arr, mode)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
@pytest.mark.parametrize("size", [(37, 53), (61, 29)])
def test_preprocess_bitwise(mode, size):
    img = _image(mode, size, seed=len(mode) + size[0])
    for px in (224, 32):
        np.testing.assert_array_equal(timaging.clip_preprocess(img, px),
                                      jimaging.clip_preprocess(img, px))
    for px in (256, 32):
        np.testing.assert_array_equal(timaging.style_preprocess(img, px),
                                      jimaging.style_preprocess(img, px))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_batchnorm_and_max_pool_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8), "bias": rng.standard_normal(8),
         "mean": rng.standard_normal(8), "var": rng.uniform(0.5, 2.0, 8)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jcommon.batchnorm(p, jnp.asarray(x))
    got = tcommon.batchnorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    for pads in (((1, 1), (1, 1)), ((0, 1), (2, 0))):
        want = jcommon.max_pool(jnp.asarray(x), 3, 2, pads)
        got = tcommon.max_pool(torch.from_numpy(x), 3, 2, pads)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    want = jcommon.max_pool(jnp.asarray(x), 2, 2, "VALID")
    got = tcommon.max_pool(torch.from_numpy(x), 2, 2, "VALID")
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("cfg", [jclip.TINY_VISION, PATCH32],
                         ids=["tiny", "patch32_hd64"])
def test_encode_image_matches_jax(cfg):
    params = jclip.init_vision(jax.random.PRNGKey(4), cfg)
    imgs = np.random.default_rng(4).standard_normal(
        (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = jclip.encode_image(params, jnp.asarray(imgs), cfg)
    tcfg = bridge.config(cfg, tclip.ClipVisionConfig)
    got = tclip.encode_image(_tree(params), torch.from_numpy(imgs), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < 1e-5, _rel(got, want)
    pooled = tclip.apply_vision(_tree(params), torch.from_numpy(imgs), tcfg,
                                project=False)
    assert pooled.shape == (3, cfg.hidden)


def test_bridge_carries_vision_and_stem_trees():
    vision = jclip.init_vision(jax.random.PRNGKey(5), jclip.TINY_VISION)
    got = _tree(vision)
    for key in ("patch_w", "class_emb", "pos_emb", "proj"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(vision[key]))
    stem = jstem.init(jax.random.PRNGKey(6))
    tstem_tree = _tree(stem)
    np.testing.assert_array_equal(
        tstem_tree["conv1"]["w"].numpy(),
        np.asarray(stem["conv1"]["w"]).transpose(3, 2, 0, 1))
    for key in ("scale", "bias", "mean", "var"):
        np.testing.assert_array_equal(tstem_tree["bn1"][key].numpy(),
                                      np.asarray(stem["bn1"][key]))
    cfg = bridge.config(jclip.TINY_VISION, tclip.ClipVisionConfig)
    assert cfg == tclip.TINY_VISION and cfg.seq_len == 17


def _stem_params(seed=7):
    """A stem with non-trivial batchnorm statistics, as torchvision
    tensors (O, I, kh, kw)."""
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((64, 3, 7, 7)).astype(np.float32) * 0.1
    bn = [rng.uniform(0.8, 1.2, 64), rng.standard_normal(64) * 0.2,
          rng.standard_normal(64) * 0.5, rng.uniform(0.5, 2.0, 64)]
    return conv, [b.astype(np.float32) for b in bn]


@pytest.mark.parametrize("px", [32, 64])
def test_style_features_match_jax(px):
    conv, bn = _stem_params()
    jp = jstem.convert_torch_stem(conv, *bn)
    tp = tstem.convert_torch_stem(conv, *bn)
    np.testing.assert_array_equal(tp["conv1"]["w"].numpy(), conv)
    imgs = np.random.default_rng(px).random((2, px, px, 3)).astype(
        np.float32)
    want = jstem.style_features(jp, jnp.asarray(imgs))
    got = tstem.style_features(tp, torch.from_numpy(imgs))
    assert got.shape == (2, 128)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the same through the bridge from the JAX tree
    got_b = tstem.style_features(_tree(jp), torch.from_numpy(imgs))
    np.testing.assert_array_equal(_np(got_b), _np(got))


def test_calc_mean_std_unbiased_and_distance():
    feat = np.random.default_rng(9).random((1, 4, 4, 8)).astype(np.float32)
    jm, js = jstem.calc_mean_std(jnp.asarray(feat))
    tm, ts = tstem.calc_mean_std(torch.from_numpy(feat))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=1e-6)
    d, sim = tstem.style_distance(torch.zeros(4), torch.tensor(
        [[3.0, 4.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]))
    np.testing.assert_allclose(d.numpy(), [5.0, 0.0])
    np.testing.assert_allclose(sim.numpy(), [1 / 6.0, 1.0])


# ---------------------------------------------------------------------------
# top-k
# ---------------------------------------------------------------------------

def _case(seed, nq, nb, d, ties=False):
    """tests/test_topk.py's integer-valued banks: exact f32 inner
    products; a small alphabet and duplicated rows give exact ties."""
    rng = np.random.default_rng(seed)
    lo, hi = (-2, 3) if ties else (-8, 8)
    bank = rng.integers(lo, hi, (nb, d)).astype(np.float32)
    queries = rng.integers(lo, hi, (nq, d)).astype(np.float32)
    if ties:
        bank[nb // 3:2 * nb // 3] = bank[:nb // 3][:nb // 3]
    return queries, bank


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]).astype(np.int64),
                                  np.asarray(want[1]).astype(np.int64))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0],
                                                          np.float32))


@pytest.mark.parametrize("nq,nb,d,k,ties", [
    (2, 1000, 512, 100, False),
    (1, 700, 64, 100, True),
    (3, 513, 32, 100, False),    # bank not a multiple of the tiles
    (4, 50, 32, 100, False),     # k > n
])
def test_topk_matches_jax(nq, nb, d, k, ties):
    q, bank = _case(nq * nb + d, nq, nb, d, ties)
    pallas = jtopk.topk_ip_pallas(q, bank, k, interpret=True)
    oracle = jtopk.topk_ip_numpy(q, bank, k)
    xla = jtopk.topk_ip(q, bank, k)
    tq, tb = torch.from_numpy(q), torch.from_numpy(bank)
    fused = ttopk.reference_topk_ip_fused(tq, tb, k)
    assert fused[0].shape == (nq, k) and fused[1].dtype == torch.int32
    _eq(fused, pallas)
    _eq(ttopk.topk_ip_fused(tq, tb, k), pallas)   # CPU: the plain version
    plain = ttopk.topk_ip(tq, tb, k)
    assert plain[0].shape == (nq, min(k, nb))
    _eq(plain, oracle)
    _eq(plain, xla)
    _eq((fused[0][:, :nb], fused[1][:, :nb]), oracle)
    if k > nb:      # the Pallas tail: fillers, kept as the JAX kernel has it
        assert (fused[0][:, nb:] == ttopk.NEG_INF).all()
        assert (fused[1][:, nb:] == 2 ** 31 - 1).all()


def test_topk_matches_faiss_fixture():
    data = np.load(FIXTURE)
    q, bank = torch.from_numpy(data["queries"]), torch.from_numpy(
        data["bank"])
    want = (data["expected_scores"], data["expected_indices"])
    k = want[1].shape[1]
    _eq(ttopk.topk_ip(q, bank, k), want)
    _eq(ttopk.reference_topk_ip_fused(q, bank, k), want)
    np.testing.assert_array_equal(
        ttopk.topk_ip_numpy(data["queries"], data["bank"], k)[1], want[1])


@pytest.mark.parametrize("alphabet", [None, 400, 3],
                         ids=["distinct", "ties_inside_margin", "ties_past"])
def test_ordered_topk_both_routes(monkeypatch, alphabet):
    """``topk_ip``'s torch.topk + margin route and its stable-sort route
    give the oracle's (score desc, index asc) order; which one runs
    depends on whether ties reach past the margin."""
    rng = np.random.default_rng(11)
    if alphabet is None:
        scores = rng.standard_normal((5, 2000)).astype(np.float32)
    else:
        scores = rng.integers(0, alphabet, (5, 2000)).astype(np.float32)
    sorts = []
    stable = ttopk._stable_topk
    monkeypatch.setattr(ttopk, "_stable_topk",
                        lambda s, k: sorts.append(k) or stable(s, k))
    vals, idx = ttopk._ordered_topk(torch.from_numpy(scores), 100)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :100]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(scores, order, 1))
    assert bool(sorts) == (alphabet == 3)


def test_topk_fused_k_limit():
    """k < 1 raises; any k >= 1 returns (Q, k), past the bank's end too,
    as ``topk_ip_pallas`` does."""
    q, bank = torch.zeros(2, 8), torch.zeros(300, 8)
    with pytest.raises(ValueError, match="k >= 1"):
        ttopk.topk_ip_fused(q, bank, 0)
    for k in (256, 257, 500):
        assert ttopk.topk_ip_fused(q, bank, k)[1].shape == (2, k)


def test_launch_or_raise_off_cpu(monkeypatch):
    """A tensor off the CPU goes to B8 and nowhere else: with its loader
    failing, ``topk_ip_fused`` and ``first_stage_topk(use_pallas=True)``
    raise and count nothing."""
    def no_kernel():
        raise RuntimeError("no B8 kernel here")

    monkeypatch.setattr(ttopk, "_lib", no_kernel)
    before = ttopk.topk_ip_fused.launches
    q = torch.empty(3, 16, device="meta")
    bank = torch.empty(40, 16, device="meta")
    with pytest.raises(RuntimeError, match="no B8 kernel"):
        ttopk.topk_ip_fused(q, bank, 10)
    eb = tret.EmbeddingBank(features=bank, paths=[f"{i}.jpg" for i in
                                                  range(40)],
                            sources=["coco"] * 40)
    with pytest.raises(RuntimeError, match="no B8 kernel"):
        tret.first_stage_topk(np.zeros((3, 16), np.float32), eb, 10,
                              use_pallas=True)
    assert ttopk.topk_ip_fused.launches == before


def test_first_stage_matches_jax_on_cpu():
    """On a CPU bank ``use_pallas=True`` takes ``topk_ip``, as the JAX
    stage does on its CPU backend; both give the fixture's answer."""
    data = np.load(FIXTURE)
    paths = [f"img_{j}.jpg" for j in range(len(data["bank"]))]
    want = jret.first_stage_topk(data["queries"], jret.EmbeddingBank(
        features=jnp.asarray(data["bank"]), paths=paths,
        sources=["coco"] * len(paths)), top_k=100)
    bank = tret.EmbeddingBank.from_sources({"coco": data["bank"]},
                                           {"coco": paths}, device="cpu")
    assert bank.features.dtype == torch.float32
    before = ttopk.topk_ip_fused.launches
    for use_pallas in (False, True):
        got = tret.first_stage_topk(data["queries"], bank, top_k=100,
                                    use_pallas=use_pallas)
        assert got == want
    assert ttopk.topk_ip_fused.launches == before


def test_meshes_raise():
    """A bank built with a one-rank mesh stays whole, as the JAX bank does
    on a one-device axis; a bank searched through a mesh
    (``sharded_topk`` over one shard) gives the unsharded results, ties
    included, and JAX's. Sharded banks over several ranks are
    ``tests/test_torch_scaleout_ops.py``'s."""
    from domainrag_tpu.parallel import mesh as jmesh
    from domainrag_tpu_torch.parallel import mesh as tmesh
    feats = {"coco": np.eye(4, 8, dtype=np.float32)}
    paths = {"coco": [f"{i}.jpg" for i in range(4)]}
    jbank = jret.EmbeddingBank.from_sources(
        feats, paths, mesh=jmesh.create_mesh(devices=jax.devices()[:1]))
    bank = tret.EmbeddingBank.from_sources(feats, paths,
                                           mesh=tmesh.create_mesh(),
                                           device="cpu")
    assert bank.mesh is None and jbank.mesh is None
    queries = np.eye(2, 8, dtype=np.float32)
    want = jret.first_stage_topk(queries, jbank, 2)
    plain = tret.first_stage_topk(queries, bank, 2)
    bank.mesh = tmesh.create_mesh()
    assert tret.first_stage_topk(queries, bank, 2) == plain == want


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

def make_corpus(root, n=12):
    rng = np.random.default_rng(7)
    corpus = root / "coco" / "train2017"
    corpus.mkdir(parents=True)
    paths = []
    for i in range(n):
        p = corpus / f"{i:012d}.jpg"
        Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    (corpus / "broken.jpg").write_bytes(b"not a jpeg")
    return paths + [str(corpus / "broken.jpg")]


def make_queries(root, dataset="NEU-DET", shot=1):
    rng = np.random.default_rng(8)
    shot_dir = root / "lamainpaint" / dataset / f"{shot}_shot"
    shot_dir.mkdir(parents=True)
    for name in ("crazing_1", "patches_3", "scratches_2"):
        Image.fromarray(rng.integers(0, 255, (48, 56, 3), dtype=np.uint8)
                        ).save(shot_dir / f"{name}.jpg")
    with open(shot_dir / "category_mapping.json", "w") as f:
        json.dump({"crazing_1": "crazing", "patches_3": "patches"}, f)
    return str(root / "lamainpaint")


@pytest.fixture(scope="module")
def encoders():
    """The JAX stage's encoders on JAX weights, and the port's on the same
    weights through the bridge."""
    cfg = jclip.TINY_VISION
    clip_p = jclip.init_vision(jax.random.PRNGKey(0), cfg)
    stem_p = jstem.init(jax.random.PRNGKey(1))
    j = (jenc.ClipImageEncoder(clip_p, cfg, batch_size=8),
         jenc.StyleEncoder(stem_p, batch_size=8, resize=32))
    t = (tenc.ClipImageEncoder(_tree(clip_p), bridge.config(
            cfg, tclip.ClipVisionConfig), batch_size=8, device="cpu"),
         tenc.StyleEncoder(_tree(stem_p), batch_size=8, resize=32,
                           device="cpu"))
    return j, t


def _run(mod, encs, corpus, lamainpaint, results_dir, device=None):
    feats, kept = mod.load_or_compute_source_features(
        results_dir, "coco", corpus, encs[0])
    kw = {} if device is None else {"device": device}
    bank = mod.EmbeddingBank.from_sources({"coco": feats}, {"coco": kept},
                                          **kw)
    out = mod.run_retrieval(["NEU-DET", "DIOR"], [1], bank, *encs,
                            lamainpaint, results_dir)
    return feats, kept, out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_json(got, want):
    """Same keys, lists, order and strings; floats within 1e-5."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _same_json(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-5, (got, want)
    else:
        assert got == want


def test_run_retrieval_matches_jax(tmp_path, encoders):
    corpus = make_corpus(tmp_path)
    lamainpaint = make_queries(tmp_path)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfeats, jkept, want = _run(jret, encoders[0], corpus, lamainpaint, jdir)
    tfeats, tkept, got = _run(tret, encoders[1], corpus, lamainpaint, tdir,
                              device="cpu")
    assert tkept == jkept == corpus[:-1]          # the broken file skipped
    np.testing.assert_allclose(tfeats, jfeats, atol=1e-5)
    assert _files(tdir) == _files(jdir)
    assert "all_shots_retrieval_results.json" in _files(tdir)
    assert "NEU-DET_1_shot_scratches_2_scratches_2_visual.jpg" in _files(tdir)
    _same_json(got, want)
    for name in _files(jdir):
        if name.endswith(".json"):
            with open(os.path.join(tdir, name)) as f, \
                    open(os.path.join(jdir, name)) as g:
                _same_json(json.load(f), json.load(g))
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(tdir, name)),
                                       np.load(os.path.join(jdir, name)),
                                       atol=1e-5)
    sims = got["NEU-DET"]["1_shot"]["crazing"][0]["similar_images"]
    assert [s["rank"] for s in sims] == list(range(1, 13))
    assert all(0 < s["similarity"] <= 1 for s in sims)
    assert "DIOR" in got and got["DIOR"] == {}            # missing shot dir
    # the caches are read back, not recomputed
    again = tret.load_or_compute_source_features(
        tdir, "coco", ["/nonexistent.jpg"], encoders[1][0])
    np.testing.assert_array_equal(again[0], tfeats)


def test_missing_shot_dir_and_no_features(tmp_path, encoders):
    bank = tret.EmbeddingBank.from_sources(
        {"coco": np.eye(4, 32, dtype=np.float32)},
        {"coco": [f"i{i}.jpg" for i in range(4)]}, device="cpu")
    args = ("NOPE", 1, bank, *encoders[1], str(tmp_path / "missing"),
            str(tmp_path / "rr"))
    assert tret.retrieve_dataset_shot(*args) == {}
    assert tret.get_inpainted_images(str(tmp_path), "NOPE", 1) == ({}, {})
    with pytest.raises(ValueError, match="no corpus features"):
        tret.EmbeddingBank.from_sources({"coco": np.zeros((0, 4))},
                                        {"coco": []}, device="cpu")


def test_load_pretrained_features_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((5, 8)).astype(np.float32)
    paths = [f"img{i}.jpg" for i in range(5)]
    npy, pj, pt = tmp_path / "f.npy", tmp_path / "p.json", tmp_path / "f.pt"
    np.save(npy, feats)
    pj.write_text(json.dumps(paths))
    cases = [(str(npy), str(pj))]
    torch.save({"features": torch.from_numpy(feats), "paths": paths},
               str(tmp_path / "d.pt"))
    cases.append((str(tmp_path / "d.pt"), ""))
    torch.save(torch.from_numpy(feats), str(pt))
    cases.append((str(pt), str(pj)))
    for args in cases:
        got, want = (tret.load_pretrained_features(*args),
                     jret.load_pretrained_features(*args))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == paths
    pj.write_text(json.dumps(paths[:3]))
    with pytest.raises(ValueError, match="mismatch"):
        tret.load_pretrained_features(str(npy), str(pj))


def test_encoders_need_no_batch_padding(encoders):
    """A short last batch gives what the same images give inside a full
    batch (the JAX wrappers pad to the batch size for jit)."""
    clip_enc = encoders[1][0]
    cfg = clip_enc.cfg
    x = np.random.default_rng(3).standard_normal(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    np.testing.assert_array_equal(clip_enc.encode_arrays(x[:3]),
                                  clip_enc.encode_arrays(x)[:3])
    np.testing.assert_allclose(clip_enc.encode_arrays(x[:3]),
                               encoders[0][0].encode_arrays(x[:3]),
                               atol=1e-5)


def test_style_encoder_memo_and_skip(tmp_path, encoders):
    paths = make_corpus(tmp_path, n=3)
    t_style = tenc.StyleEncoder(encoders[1][1]._params, batch_size=2,
                                resize=32, device="cpu")
    got = t_style.encode_paths(paths)
    want = encoders[0][1].encode_paths(paths)
    assert list(got) == list(want) == paths[:-1]
    for p in paths[:-1]:
        np.testing.assert_allclose(got[p], want[p], atol=1e-5)
    cached = t_style._cache[paths[0]]
    assert t_style.encode_paths(paths[:1])[paths[0]] is cached
