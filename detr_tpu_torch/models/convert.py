"""Weights in and out of the port: JAX parameter trees, converted
torchvision trunks (.npz) and the reference's ``model.safetensors``.

``state_dict_from_jax`` is the port's own copy of the mapping in
``detr_tpu/models/convert.py::export_detr_state_dict``: numpy trees
``{"params", "frozen"}`` as the JAX package's DETR holds them in, the
reference ``state_dict`` layout out, which is the port's module naming, so
``DETR.load_state_dict(..., strict=True)`` takes the result.

Converted torchvision trunks: ``convert_torch_state_dict`` maps a
torchvision ResNet-50/101 ``state_dict`` to the JAX package's trunk trees
(the port's own copy of ``detr_tpu/models/convert.py``'s mapping),
``save_backbone_npz`` writes them as the .npz that
``DETRConfig.backbone_weights`` names (the JAX package's keys and layout,
so either package reads the other's file), and ``load_backbone_npz`` and
``apply_backbone_weights`` load such a file into the port's trunk.  The
offline dump, on a machine with torchvision (imported only there)::

    python -m detr_tpu_torch.models.convert out.npz [resnet50|resnet101]

``load_reference_checkpoint`` and ``save_reference_checkpoint`` read and
write the reference's ``model.safetensors``, whose names already
are the port's, with the port's own reader and writer of the safetensors
format (``load_safetensors``, ``save_safetensors``).

  * Dense kernels (in, out) transpose to ``Linear.weight`` (out, in);
  * the 1x1 ``input_proj`` Dense becomes a conv weight (out, in, 1, 1);
  * conv kernels HWIO become OIHW;
  * frozen BN scale/bias/mean/var become ``weight/bias/running_mean/
    running_var``;
  * ``layerX_blockY`` becomes ``layerX.Y``, ``downsample_conv/_bn`` becomes
    ``downsample.0/1``; FFN ``fc1/fc2`` become ``layers.0/3``; the box MLP's
    ``fc{i}`` becomes ``net.{2i}``.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping, Optional

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig

def state_dict_from_jax(
    params: Mapping, frozen: Mapping, config: DETRConfig
) -> dict[str, torch.Tensor]:
    sd: dict[str, np.ndarray] = {}

    def f32(x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def dense(prefix, tree):
        sd[f"{prefix}.weight"] = f32(tree["kernel"]).T
        sd[f"{prefix}.bias"] = f32(tree["bias"])

    def ln(prefix, tree):
        sd[f"{prefix}.weight"] = f32(tree["scale"])
        sd[f"{prefix}.bias"] = f32(tree["bias"])

    def attention(prefix, tree):
        for name in ("query_proj", "key_proj", "value_proj", "output_proj"):
            dense(f"{prefix}.{name}", tree[name])

    def ffn(prefix, tree):
        dense(f"{prefix}.layers.0", tree["fc1"])
        dense(f"{prefix}.layers.3", tree["fc2"])

    sd["input_proj.weight"] = f32(params["input_proj"]["kernel"]).T[:, :, None, None]
    sd["input_proj.bias"] = f32(params["input_proj"]["bias"])
    sd["object_query_embedding.weight"] = f32(params["object_query_embedding"])
    dense("class_embedding", params["class_embedding"])
    for i in range(config.box_embedding_mlp_num_layers):
        dense(f"bbox_embedding.net.{2 * i}", params["bbox_embedding"][f"fc{i}"])

    ln("encoder.norm", params["encoder"]["norm"])
    for i in range(config.num_encoder_layers):
        layer, p = params["encoder"][f"layer{i}"], f"encoder.layers.{i}"
        ln(f"{p}.norm1", layer["norm1"])
        ln(f"{p}.norm2", layer["norm2"])
        attention(f"{p}.self_attention", layer["self_attention"])
        ffn(f"{p}.ffn", layer["ffn"])

    ln("decoder.norm", params["decoder"]["norm"])
    for i in range(config.num_decoder_layers):
        layer, p = params["decoder"][f"layer{i}"], f"decoder.layers.{i}"
        ln(f"{p}.norm1", layer["norm1"])
        ln(f"{p}.norm2", layer["norm2"])
        ln(f"{p}.norm3", layer["norm3"])
        attention(f"{p}.self_attention", layer["self_attention"])
        attention(f"{p}.cross_attention", layer["cross_attention"])
        ffn(f"{p}.ffn", layer["ffn"])

    sd.update(_trunk_state_dict(params["backbone"], frozen["backbone"], "backbone.backbone."))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _trunk_state_dict(bb_params: Mapping, bb_frozen: Mapping,
                      prefix: str = "") -> dict[str, np.ndarray]:
    """The JAX trunk's trees (ResNet-50 or 101, by the blocks they hold) ->
    torchvision-named fp32 arrays under ``prefix``."""
    sd: dict[str, np.ndarray] = {}

    def conv(name, tree):
        sd[f"{prefix}{name}.weight"] = np.transpose(np.asarray(tree["kernel"], np.float32),
                                                    (3, 2, 0, 1))

    def bn(name, tree):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}{name}.{ours}"] = np.asarray(tree[theirs], np.float32)

    conv("conv1", bb_params["conv1"])
    bn("bn1", bb_frozen["bn1"])
    for stage in range(1, 5):
        n = sum(1 for k in bb_params if k.startswith(f"layer{stage}_block"))
        for b in range(n):
            name, tprefix = f"layer{stage}_block{b}", f"layer{stage}.{b}"
            for ci in (1, 2, 3):
                conv(f"{tprefix}.conv{ci}", bb_params[name][f"conv{ci}"])
                bn(f"{tprefix}.bn{ci}", bb_frozen[name][f"bn{ci}"])
            if "downsample_conv" in bb_params[name]:
                conv(f"{tprefix}.downsample.0", bb_params[name]["downsample_conv"])
                bn(f"{tprefix}.downsample.1", bb_frozen[name]["downsample_bn"])
    return sd


# ---- converted torchvision trunks (.npz) ----

_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def _hwio(w) -> np.ndarray:
    """A torch conv weight (O, I, H, W) -> the JAX trunk's kernel (H, W, I, O)."""
    return np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0))


def _bn_tree(sd: Mapping, prefix: str) -> dict[str, np.ndarray]:
    return {ours: np.asarray(sd[f"{prefix}.{theirs}"], np.float32)
            for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                                 ("mean", "running_mean"), ("var", "running_var"))}


def convert_torch_state_dict(sd: Mapping, backbone: str = "resnet50") -> tuple[dict, dict]:
    """A torchvision ResNet ``state_dict`` (name -> array or CPU tensor;
    ``fc.*`` and ``num_batches_tracked`` are not read) -> (params, frozen),
    the JAX package's trunk trees: conv kernels HWIO under ``conv1`` and
    ``layerX_blockY/conv{1,2,3}`` / ``downsample_conv``, BatchNorm
    scale/bias/mean/var under ``bn1``, ``layerX_blockY/bn{1,2,3}`` /
    ``downsample_bn``; fp32 numpy."""
    params: dict = {"conv1": {"kernel": _hwio(sd["conv1.weight"])}}
    frozen: dict = {"bn1": _bn_tree(sd, "bn1")}
    for stage, n in enumerate(_STAGES[backbone], start=1):
        for b in range(n):
            name, tprefix = f"layer{stage}_block{b}", f"layer{stage}.{b}"
            p = {f"conv{ci}": {"kernel": _hwio(sd[f"{tprefix}.conv{ci}.weight"])}
                 for ci in (1, 2, 3)}
            f = {f"bn{ci}": _bn_tree(sd, f"{tprefix}.bn{ci}") for ci in (1, 2, 3)}
            if f"{tprefix}.downsample.0.weight" in sd:
                p["downsample_conv"] = {"kernel": _hwio(sd[f"{tprefix}.downsample.0.weight"])}
                f["downsample_bn"] = _bn_tree(sd, f"{tprefix}.downsample.1")
            params[name], frozen[name] = p, f
    return params, frozen


def save_backbone_npz(path: str, sd: Mapping, backbone: str) -> None:
    """``convert_torch_state_dict``'s trees flattened into one .npz, keyed
    "params:<module>/kernel" and "frozen:<module>/{scale,bias,mean,var}"."""
    params, frozen = convert_torch_state_dict(sd, backbone)
    flat: dict[str, np.ndarray] = {}

    def walk(tree: Mapping, prefix: str, kind: str) -> None:
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key, kind)
            else:
                flat[f"{kind}:{key}"] = v

    walk(params, "", "params")
    walk(frozen, "", "frozen")
    np.savez(path, **flat)

def load_backbone_npz(path: str) -> tuple[dict, dict]:
    """An .npz of ``detr_tpu/models/convert.py::save_backbone_npz``'s layout
    ("params:<module>/kernel", "frozen:<module>/{scale,bias,mean,var}", the
    JAX trunk's names) -> (params, frozen) trees of numpy arrays."""
    params: dict = {}
    frozen: dict = {}
    with np.load(path) as data:
        for key in data.files:
            kind, rest = key.split(":", 1)
            node = params if kind == "params" else frozen
            parts = rest.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params, frozen


def apply_backbone_weights(model: torch.nn.Module, params: Mapping, frozen: Mapping) -> None:
    """Load ``load_backbone_npz``'s trees into ``model.backbone.backbone``,
    in place: every tensor of the trunk, each of exactly its shape (a
    transposed or missing tensor raises)."""
    trunk = model.backbone.backbone
    sd = _trunk_state_dict(params, frozen)
    want = trunk.state_dict()
    for name, value in sd.items():
        if name in want and tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(
                f"{name}: converted shape {value.shape} != model {tuple(want[name].shape)}")
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


# ---- the reference's model.safetensors ----

# safetensors dtype names <-> torch dtypes (little-endian raw bytes)
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's elements in C order as little-endian bytes."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write the safetensors format: an 8-byte little-endian header length,
    a JSON header {name: {dtype, shape, data_offsets}} padded with spaces to
    8 bytes, then every tensor's raw bytes back to back."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        blob = _raw(t)
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors (``save_safetensors``'s
    format, as the ``safetensors`` package writes it)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']}")
        start, end = info["data_offsets"]
        view = torch.int16 if dtype == torch.bfloat16 else dtype
        np_dtype = torch.empty((), dtype=view).numpy().dtype.newbyteorder("<")
        a = np.frombuffer(data[start:end], dtype=np_dtype).reshape(info["shape"])
        t = torch.from_numpy(a.astype(a.dtype.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
    return out


def load_reference_checkpoint(path: str, config: DETRConfig) -> dict[str, torch.Tensor]:
    """A reference ``model.safetensors`` -> the port's ``state_dict`` for
    ``config`` (fp32): the model's own keys, each of its exact shape; other
    keys of the file are left out.  ``DETR.load_state_dict(strict=True)``
    takes the result."""
    from detr_tpu_torch.models.detr import DETR

    with torch.device("meta"):
        want = DETR(config).state_dict()
    sd = load_safetensors(path)
    out = {}
    for name, ref in want.items():
        if name not in sd:
            raise KeyError(f"{path} lacks {name}")
        if tuple(sd[name].shape) != tuple(ref.shape):
            raise ValueError(
                f"{name}: file shape {tuple(sd[name].shape)} != model {tuple(ref.shape)}")
        out[name] = sd[name].to(torch.float32)
    return out


def save_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Write a model as a reference-loadable ``model.safetensors``: every
    parameter and frozen statistic, fp32, under the reference's names (the
    weights-only resume format of the reference)."""
    save_safetensors(path, {k: v.float() for k, v in model.state_dict().items()})


def _main(argv) -> int:  # needs torchvision and its weights
    """Offline dump: python -m detr_tpu_torch.models.convert out.npz [resnet50]."""
    import torchvision.models as tvm

    out = argv[1]
    backbone = argv[2] if len(argv) > 2 else "resnet50"
    model = tvm.get_model(backbone, weights="DEFAULT")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    save_backbone_npz(out, sd, backbone)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv))
