"""Real-checkpoint conversion: safetensors state dicts -> param trees (port
of ``domainrag_tpu/models/convert.py``).

The reference loads everything ``from_pretrained`` local dirs
(``./model/FLUX.1-dev`` etc. — batch_generate_flux_kshot.py:21-23,117-153).
This module converts those checkpoints (diffusers / transformers layouts)
into the port's param trees, with the JAX package's keys and the port's
layouts: linear weights (in, out), convolution weights torch's
(out, in, kh, kw) as the files hold them, quantized ``w_q`` K-major.

The safetensors format is read here, not through the ``safetensors``
package: an 8-byte little-endian header length, a JSON header
(``dtype``, ``shape``, ``data_offsets`` per tensor), then the raw bytes.
Each tensor is mapped from its file on demand and viewed with
``torch.frombuffer``, so bf16 files need no numpy dtype and the host
holds one tensor at a time. Every converter moves a tensor to its
device at the file's width and casts it there: the MMDiT lands in the
bundle's compute dtype (bf16 at full width), the towers, the VAE and the
retrieval and inpaint models in f32, as the port's bundles hold them.

No network access is assumed: all loaders take local paths.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..core import device as device_mod
from ..core import prng
from ..core import text as text_util
from ..core.log import StepTimer, get_logger
from . import clip as clip_mod
from . import lama as lama_mod
from . import redux as redux_mod
from . import siglip as siglip_mod
from . import t5 as t5_mod
from .common import Params, ckpt_linear, ckpt_tensor
from .flux import model as flux_mod
from .flux import vae as vae_mod

logger = get_logger("domainrag_tpu_torch.convert")

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def host_conversion():
    """Context manager under which factory calls that name no device build
    on the host (torch's ``torch.device("cpu")`` context), as the JAX
    ``host_conversion`` keeps conversion off the accelerator. The
    converters here take ``device=`` and place their tensors themselves."""
    return torch.device("cpu")


class _SafetensorsFile:
    """One safetensors file: its header, read once; each tensor mapped
    from the file when asked for (the mapping closes with the tensor)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.data_start = 8 + n
        # key order inside a file: sorted, as safetensors' keys() gives it
        self.entries = {k: header[k] for k in sorted(header)}

    def tensor(self, key: str) -> torch.Tensor:
        entry = self.entries[key]
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{self.path}: {key} has unsupported dtype "
                             f"{entry['dtype']}")
        dtype = _DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        start = self.data_start + begin
        base = start - start % mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            mapped = mmap.mmap(f.fileno(), self.data_start + end - base,
                               access=mmap.ACCESS_READ, offset=base)
        with warnings.catch_warnings():
            # the mapping is read-only; converters copy before any write
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(mapped, dtype=torch.uint8,
                                   count=end - begin, offset=start - base)
        if (start - base) % dtype.itemsize:
            raw = raw.clone()                  # unaligned: copy out
        return raw.view(dtype).reshape(shape)


class _LazySafetensors:
    """Read-on-demand Mapping over one or more safetensors files.

    Each ``__getitem__`` maps exactly one tensor from its file and nothing
    is cached, so the source tree contributes one tensor at a time to the
    host's peak (the JAX loader's eager dict once held 69.5 GB). Key order
    is file order, then sorted key order within each file (the LaMa
    ordered-leaves contract, :func:`convert_lama`)."""

    def __init__(self, files):
        self._index: Dict[str, _SafetensorsFile] = {}
        for path in files:
            f = _SafetensorsFile(path)
            for k in f.entries:
                self._index[k] = f

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._index[key].tensor(key)

    def __contains__(self, key) -> bool:
        return key in self._index

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def items(self):
        return ((k, self[k]) for k in self._index)


def load_safetensors_dir(path: str, lazy: bool = True):
    """All ``*.safetensors`` under ``path`` as one mapping of CPU tensors —
    lazy (read-on-demand, mapped from the files) by default;
    ``lazy=False`` gives the eager merged dict, copied out of the
    files."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files and os.path.isfile(path):
        files = [path]
    state = _LazySafetensors(files)
    if lazy:
        return state
    return {k: v.clone() for k, v in state.items()}


# ---------------------------------------------------------------------------
# Flux transformer (diffusers FluxTransformer2DModel layout)
# ---------------------------------------------------------------------------

def convert_flux_transformer(sd, cfg: flux_mod.FluxConfig,
                             block_transform=None, *, device=None,
                             dtype: torch.dtype = torch.float32) -> Params:
    """diffusers Flux transformer state dict -> MMDiT tree on ``device``
    (the card unless ``device="cpu"``): linears in ``dtype``, the qk-norm
    scales in f32 (as ``flux.model.init`` keeps them). ``block_transform``
    (e.g. ``quant.quantize_tree``) applies to each double/single block
    right after it is built, so one unquantized block at a time is
    resident."""
    dev = device_mod.resolve(device)

    def lin(prefix):
        return ckpt_linear(sd, prefix, dev, dtype)

    def cat_lin(prefixes):
        """Linear layers concatenated along the OUTPUT dim (fused qkv)."""
        out = {"w": torch.cat([ckpt_tensor(sd[f"{p}.weight"], dev, dtype).t()
                               for p in prefixes], dim=1)}
        if f"{prefixes[0]}.bias" in sd:
            out["b"] = torch.cat([ckpt_tensor(sd[f"{p}.bias"], dev, dtype)
                                  for p in prefixes])
        return out

    def qknorm(q_key, k_key):
        return {"q": {"scale": ckpt_tensor(sd[q_key], dev)},
                "k": {"scale": ckpt_tensor(sd[k_key], dev)}}

    def mlp_embedder(prefix):
        return {"in": lin(f"{prefix}.linear_1"),
                "out": lin(f"{prefix}.linear_2")}

    params: Params = {
        "img_in": lin("x_embedder"),
        "txt_in": lin("context_embedder"),
        "time_in": mlp_embedder("time_text_embed.timestep_embedder"),
        "vector_in": mlp_embedder("time_text_embed.text_embedder"),
        "double": [], "single": [],
    }
    if cfg.guidance_embed:
        params["guidance_in"] = mlp_embedder(
            "time_text_embed.guidance_embedder")

    tf = block_transform if block_transform is not None else (lambda x: x)
    i = 0
    while f"transformer_blocks.{i}.norm1.linear.weight" in sd:
        pre = f"transformer_blocks.{i}"
        params["double"].append(tf({
            "img_mod": lin(f"{pre}.norm1.linear"),
            "txt_mod": lin(f"{pre}.norm1_context.linear"),
            "img_qkv": cat_lin([f"{pre}.attn.to_q", f"{pre}.attn.to_k",
                                f"{pre}.attn.to_v"]),
            "txt_qkv": cat_lin([f"{pre}.attn.add_q_proj",
                                f"{pre}.attn.add_k_proj",
                                f"{pre}.attn.add_v_proj"]),
            "img_qknorm": qknorm(f"{pre}.attn.norm_q.weight",
                                 f"{pre}.attn.norm_k.weight"),
            "txt_qknorm": qknorm(f"{pre}.attn.norm_added_q.weight",
                                 f"{pre}.attn.norm_added_k.weight"),
            "img_proj": lin(f"{pre}.attn.to_out.0"),
            "txt_proj": lin(f"{pre}.attn.to_add_out"),
            "img_mlp1": lin(f"{pre}.ff.net.0.proj"),
            "img_mlp2": lin(f"{pre}.ff.net.2"),
            "txt_mlp1": lin(f"{pre}.ff_context.net.0.proj"),
            "txt_mlp2": lin(f"{pre}.ff_context.net.2"),
        }))
        i += 1
    i = 0
    while f"single_transformer_blocks.{i}.norm.linear.weight" in sd:
        pre = f"single_transformer_blocks.{i}"
        params["single"].append(tf({
            "mod": lin(f"{pre}.norm.linear"),
            "linear1": cat_lin([f"{pre}.attn.to_q", f"{pre}.attn.to_k",
                                f"{pre}.attn.to_v", f"{pre}.proj_mlp"]),
            "linear2": lin(f"{pre}.proj_out"),
            "qknorm": qknorm(f"{pre}.attn.norm_q.weight",
                             f"{pre}.attn.norm_k.weight"),
        }))
        i += 1

    # diffusers AdaLayerNormContinuous emits (scale, shift); the final
    # layer consumes (shift, scale) — swap the halves.
    final = lin("norm_out.linear")
    h = final["w"].shape[1] // 2
    params["final_mod"] = {
        "w": torch.cat([final["w"][:, h:], final["w"][:, :h]], dim=1),
        "b": torch.cat([final["b"][h:], final["b"][:h]]),
    }
    params["final_proj"] = lin("proj_out")
    return params


# ---------------------------------------------------------------------------
# Flux VAE (diffusers AutoencoderKL layout)
# ---------------------------------------------------------------------------

def convert_flux_vae(sd, cfg: vae_mod.VaeConfig, *, device=None) -> Params:
    """diffusers ``AutoencoderKL`` state dict -> VAE tree, f32 on
    ``device`` (the card unless ``device="cpu"``). Convolutions keep the
    file's (out, in, kh, kw); the mid-block attention's linears become
    1x1 convolutions."""
    dev = device_mod.resolve(device)

    def conv(prefix):
        p = {"w": ckpt_tensor(sd[f"{prefix}.weight"], dev)}
        if f"{prefix}.bias" in sd:
            p["b"] = ckpt_tensor(sd[f"{prefix}.bias"], dev)
        return p

    def gn(prefix):
        return {"scale": ckpt_tensor(sd[f"{prefix}.weight"], dev),
                "bias": ckpt_tensor(sd[f"{prefix}.bias"], dev)}

    def resnet(prefix):
        p = {"norm1": gn(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1"),
             "norm2": gn(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = conv(f"{prefix}.conv_shortcut")
        return p

    def attn(prefix):
        def lin_as_conv(name):
            p = conv(f"{prefix}.{name}")
            if p["w"].dim() == 2:          # Linear (out, in) -> 1x1 conv
                p["w"] = p["w"][:, :, None, None]
            return p

        return {"norm": gn(f"{prefix}.group_norm"),
                "q": lin_as_conv("to_q"), "k": lin_as_conv("to_k"),
                "v": lin_as_conv("to_v"), "o": lin_as_conv("to_out.0")}

    def mid(prefix):
        return {"res1": resnet(f"{prefix}.resnets.0"),
                "attn": attn(f"{prefix}.attentions.0"),
                "res2": resnet(f"{prefix}.resnets.1")}

    def stages(prefix, key, sampler):
        """Resnet stages ``{prefix}.{i}`` with an optional
        ``{sampler}.0.conv`` stored under ``key``."""
        out, i = [], 0
        while f"{prefix}.{i}.resnets.0.norm1.weight" in sd:
            pre = f"{prefix}.{i}"
            stage: Params = {"res": []}
            j = 0
            while f"{pre}.resnets.{j}.norm1.weight" in sd:
                stage["res"].append(resnet(f"{pre}.resnets.{j}"))
                j += 1
            if f"{pre}.{sampler}.0.conv.weight" in sd:
                stage[key] = conv(f"{pre}.{sampler}.0.conv")
            out.append(stage)
            i += 1
        return out

    enc = {"conv_in": conv("encoder.conv_in"),
           "down": stages("encoder.down_blocks", "down", "downsamplers"),
           "mid": mid("encoder.mid_block"),
           "norm_out": gn("encoder.conv_norm_out"),
           "conv_out": conv("encoder.conv_out")}
    dec = {"conv_in": conv("decoder.conv_in"),
           "mid": mid("decoder.mid_block"),
           "up": stages("decoder.up_blocks", "up", "upsamplers"),
           "norm_out": gn("decoder.conv_norm_out"),
           "conv_out": conv("decoder.conv_out")}
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# full-deployment loader
# ---------------------------------------------------------------------------

def default_configs(fill: bool = False) -> dict:
    """Production model configs per checkpoint subdir; the real-weights
    harness overrides these with tiny configs for its self-test mode."""
    return {
        "flux": flux_mod.FLUX_FILL_DEV if fill else flux_mod.FLUX_DEV,
        "vae": vae_mod.FLUX_VAE,
        "t5": t5_mod.T5_XXL,
        "clip_text": clip_mod.ClipTextConfig(),
        "siglip": siglip_mod.SIGLIP_SO400M,
        "redux": redux_mod.REDUX_DEV,
    }


def _subtree(checkpoints_dir: str, sub: str, convert, timer: StepTimer):
    """``convert`` of ``checkpoints_dir/sub``'s tensors, as a
    ``load/{sub}`` span of ``timer``."""
    with timer.span(f"load/{sub}"):
        return convert(load_safetensors_dir(
            os.path.join(checkpoints_dir, sub)))


def _shared_parts(checkpoints_dir: str, c: dict, dev: torch.device,
                  timer: StepTimer) -> dict:
    """The VAE, the text towers, SigLIP + Redux and the tokenizers: what a
    FLUX.1-dev and a FLUX.1-Fill-dev deployment of one checkpoint tree
    hold alike."""
    parts = dict(
        vae_params=_subtree(checkpoints_dir, "vae", lambda sd:
                            convert_flux_vae(sd, c["vae"], device=dev),
                            timer),
        t5_params=_subtree(checkpoints_dir, "t5", lambda sd:
                           t5_mod.convert_hf_t5(sd, c["t5"], device=dev),
                           timer),
        clip_text_params=_subtree(
            checkpoints_dir, "clip-text", lambda sd:
            clip_mod.convert_hf_clip_text(sd, c["clip_text"], device=dev),
            timer),
        siglip_params=_subtree(
            checkpoints_dir, "siglip", lambda sd:
            siglip_mod.convert_hf_siglip(sd, c["siglip"], device=dev),
            timer),
        redux_params=_subtree(checkpoints_dir, "redux", lambda sd:
                              redux_mod.convert_hf_redux(sd, device=dev),
                              timer))
    try:
        parts["clip_tokenizer"], parts["t5_tokenizer"] = \
            text_util.load_hf_tokenizers(checkpoints_dir)
    except Exception as e:    # noqa: BLE001 — no usable tokenizer files
        logger.warning("no tokenizers under %s (%s: %s): prompts are "
                       "tokenized by the stub tokenizers, not FLUX.1's",
                       checkpoints_dir, type(e).__name__, e)
        cv = c["clip_text"].vocab_size
        parts["clip_tokenizer"] = text_util.StubTokenizer(
            vocab_size=cv, bos_id=cv - 2, eos_id=cv - 1)
        parts["t5_tokenizer"] = text_util.StubTokenizer(
            vocab_size=c["t5"].vocab_size, bos_id=None, eos_id=1)
    return parts


def _bundle(checkpoints_dir: str, fill: bool, compute_dtype: torch.dtype,
            configs: Optional[dict], dev: torch.device, timer: StepTimer,
            shared: Optional[dict] = None):
    from .flux import pipeline as flux_pipeline

    c = dict(default_configs(fill))
    c.update(configs or {})
    if shared is None:
        shared = _shared_parts(checkpoints_dir, c, dev, timer)
    name = "flux-fill" if fill else "flux-dev"
    flux_params = _subtree(
        checkpoints_dir, name, lambda sd: convert_flux_transformer(
            sd, c["flux"], device=dev, dtype=compute_dtype), timer)
    return flux_pipeline.FluxBundle(
        flux_params=flux_params, flux_cfg=c["flux"], vae_cfg=c["vae"],
        t5_cfg=c["t5"], clip_text_cfg=c["clip_text"],
        siglip_cfg=c["siglip"], redux_cfg=c["redux"],
        t5_max_len=c.get("t5_max_len", 512),
        clip_max_len=min(77, c["clip_text"].max_len),
        compute_dtype=compute_dtype, device=dev, **shared)


def load_flux_bundle(checkpoints_dir: str, fill: bool = False,
                     compute_dtype=torch.bfloat16,
                     configs: Optional[dict] = None, *, device=None):
    """Build a FluxBundle on ``device`` (the card unless ``device="cpu"``)
    from a converted checkpoint tree:

    {checkpoints_dir}/
      flux-dev/ (or flux-fill/)  transformer safetensors
      vae/  t5/  clip-text/  siglip/  redux/  (safetensors each)
      tokenizer dirs per HF layout (optional; stub tokenizers otherwise)

    The MMDiT is stored in ``compute_dtype``, everything else in f32.
    ``configs`` overrides the production model configs (keys of
    :func:`default_configs`)."""
    return _bundle(checkpoints_dir, fill, compute_dtype, configs,
                   device_mod.resolve(device), StepTimer())


def _to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def build_runner_from_checkpoints(checkpoints_dir: str, cfg,
                                  corpus_sources: Optional[dict] = None,
                                  configs: Optional[dict] = None, *,
                                  device=None):
    """PipelineRunner with real weights (CLI --checkpoints), on ``device``
    (the card unless ``device="cpu"``).

    ``configs`` may additionally carry "clip_vision" / "lama" overrides;
    as in the JAX package, the same ``configs`` reach the Fill bundle, so
    a ``configs["flux"]`` overrides the Fill MMDiT's config too. The two
    bundles share one copy of the VAE, the text towers, SigLIP and Redux
    (the same subdirectories give the same tensors), which is what lets
    both FLUX.1 deployments stay resident on one 80 GB card. The runner's
    timer holds a ``load/{subdir}`` span per subtree read."""
    from ..pipeline.orchestrator import PipelineRunner
    from ..stages import inpaint as inpaint_stage
    from ..stages.encoders import ClipImageEncoder, StyleEncoder
    from . import resnet_stem

    dev = device_mod.resolve(device)
    timer = StepTimer(sync=torch.cuda.synchronize if dev.type == "cuda"
                      else None)
    configs = configs or {}
    clip_vision_cfg = configs.get("clip_vision", clip_mod.ClipVisionConfig())
    lama_cfg = configs.get("lama", lama_mod.BIG_LAMA)
    clip_vision = _subtree(
        checkpoints_dir, "clip-vision", lambda sd:
        clip_mod.convert_hf_clip_vision(sd, clip_vision_cfg, device=dev),
        timer)
    stem_params = _subtree(
        checkpoints_dir, "resnet-stem", lambda sd: _to(
            resnet_stem.convert_torch_stem(
                sd["conv1.weight"], sd["bn1.weight"], sd["bn1.bias"],
                sd["bn1.running_mean"], sd["bn1.running_var"]), dev),
        timer)
    lama_params = _subtree(
        checkpoints_dir, "lama", lambda sd: convert_lama(sd, lama_cfg,
                                                         device=dev), timer)
    c = dict(default_configs(False))
    c.update(configs)
    shared = _shared_parts(checkpoints_dir, c, dev, timer)
    return PipelineRunner(
        cfg=cfg,
        lama_runner=inpaint_stage.LamaRunner(lama_params, lama_cfg,
                                             device=dev),
        clip_encoder=ClipImageEncoder(clip_vision, clip_vision_cfg,
                                      device=dev),
        style_encoder=StyleEncoder(stem_params, device=dev),
        flux_bundle=_bundle(checkpoints_dir, False, torch.bfloat16,
                            configs, dev, timer, shared),
        fill_bundle=_bundle(checkpoints_dir, True, torch.bfloat16,
                            configs, dev, timer, shared),
        corpus_sources=corpus_sources or {},
        timer=timer,
    )


# ---------------------------------------------------------------------------
# LaMa (ordered leaves)
# ---------------------------------------------------------------------------

def lama_leaf_order(params) -> list:
    """Deterministic topological walk of a LaMa param tree: (path, leaf)
    pairs in module order (the order a torch Sequential export emits)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            # fixed intra-module order mirroring torch module ordering
            order = ["w", "b", "scale", "bias", "mean", "var",
                     "l2l", "l2g", "g2l", "g2g", "bn_l", "bn_g",
                     "conv1", "bn1", "fu", "conv2", "conv", "bn",
                     "stem", "down", "blocks", "up", "head"]
            keys = sorted(node.keys(),
                          key=lambda k: (order.index(k)
                                         if k in order else len(order), k))
            for k in keys:
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(params, ())
    return out


def convert_lama(sd, cfg, *, device=None) -> Params:
    """big-lama generator state dict -> param tree on ``device`` (the card
    unless ``device="cpu"``), f32, by ORDERED shape matching (the
    TorchScript export's parameter names vary by export, but
    ``state_dict()`` iteration follows module order, which matches
    :func:`lama_leaf_order`).

    Every source tensor must match the next expected leaf's torch-layout
    shape, else conversion aborts with the offending key; 0-d entries like
    ``num_batches_tracked`` are skipped. Every 4-D leaf is expected as
    (O, I, kh, kw) and kept so, the transposed convs of the up path
    included — as in the JAX package, whose check asks the same shape of
    them; a torch ``ConvTranspose2d`` stores (I, O, kh, kw), so such a
    weight with c_in != c_out is refused."""
    dev = device_mod.resolve(device)
    # the shapes alone: drawn on the meta device, it costs no memory
    template = lama_mod.init(prng.PRNGKey(0, device="meta"), cfg)
    expected = lama_leaf_order(template)

    tensors = [(k, v) for k, v in sd.items() if np.ndim(v) > 0]
    if len(tensors) != len(expected):
        raise ValueError(
            f"source has {len(tensors)} tensors, template expects "
            f"{len(expected)}")

    leaves = {}
    for (path, spec), (key, tensor) in zip(expected, tensors):
        shape, want = tuple(tensor.shape), tuple(spec.shape)
        if shape != want:
            if len(want) == 4:
                raise ValueError(
                    f"{key}: shape {shape} does not match expected conv "
                    f"{want} for {path}")
            raise ValueError(f"{key}: shape {shape} != expected {want} "
                             f"for {path}")
        leaves[path] = ckpt_tensor(tensor, dev)

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v, path + (i,)) for i, v in enumerate(node)]
        return leaves[path]

    return rebuild(template, ())
