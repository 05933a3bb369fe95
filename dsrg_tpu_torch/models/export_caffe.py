"""Export a state_dict to the Caffe ``.caffemodel`` wire format
(``dsrg_tpu/models/export_caffe.py``, the port's own copy).

The inverse of ``import_caffe``: a V2 NetParameter (layer field 100,
BlobProto data field 5 and shape field 7) that ``load_caffemodel``, and any
Caffe build, reads back bit for bit.  Given the same arrays the file is byte
for byte the JAX writer's.  Layer names are the importer's:

  VGG16-LargeFOV: the prototxt's layer names (conv1_1 .. fc8-SEC_k).
  ResNet-101 DeepLab-v2: convolutions ``conv1`` / ``res{S}{blk}_branch{1,2a,2b,2c}``,
    BatchNorm ``bn...`` with [mean, var, [1.0]], Scale ``scale...`` with
    [gamma, beta], heads ``fc1_voc12_c{k}``.

The ResNet warm start rests on it: the reference never trains its ResNet
from scratch (frozen BN), so ``tools/calibrate_bn.py`` calibrates BN
statistics on data, writes them here, and the trainer re-imports the file
through ``--weights *.caffemodel``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from dsrg_tpu_torch.models.import_caffe import RESNET_BN_BRANCH, RESNET_CONV_BRANCH, caffe_block_names


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _blob(arr: np.ndarray) -> bytes:
    data = _len_field(5, np.ascontiguousarray(arr, "<f4").tobytes())
    return data + _len_field(7, _len_field(1, b"".join(_varint(int(d)) for d in arr.shape)))


def _layer(name: str, blobs: List[np.ndarray], ltype: str = "Convolution") -> bytes:
    payload = _len_field(1, name.encode()) + _len_field(2, ltype.encode())
    payload += b"".join(_len_field(7, _blob(np.asarray(b))) for b in blobs)
    return _len_field(100, payload)


def write_caffemodel(path: str, layers: Mapping[str, List[np.ndarray]], net_name: str = "dsrg-tpu-export") -> None:
    """Write ``{layer_name: [blobs]}`` as a V2 .caffemodel."""
    parts = [_len_field(1, net_name.encode())] + [_layer(name, blobs) for name, blobs in layers.items()]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def vgg_params_to_blobs(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, List[np.ndarray]]:
    """A ``DeepLabLargeFOV`` state_dict -> Caffe blobs by layer name
    (weights OIHW, then the bias)."""
    out: Dict[str, List[np.ndarray]] = {}
    for key, t in state_dict.items():
        layer, kind = key.rsplit(".", 1)
        if kind == "weight":
            out[layer] = [_np(t)] + ([_np(state_dict[f"{layer}.bias"])] if f"{layer}.bias" in state_dict else [])
    return out


def resnet_variables_to_blobs(state_dict: Mapping[str, torch.Tensor],
                              stage_blocks=(3, 4, 23, 3)) -> Dict[str, List[np.ndarray]]:
    """A ``ResNet101DeepLab`` state_dict (parameters and BN buffers) ->
    DeepLab-v2 blobs, the exact inverse of ``resnet_blobs_to_torch`` (scale
    factor 1): a BN's running statistics become [mean, var, [1.0]], its
    scale and offset the Scale layer's [gamma, beta]."""
    out: Dict[str, List[np.ndarray]] = {}

    def put_bn(prefix: str, caffe_suffix: str) -> None:
        out[f"bn{caffe_suffix}"] = [_np(state_dict[f"{prefix}.running_mean"]),
                                    _np(state_dict[f"{prefix}.running_var"]), np.asarray([1.0], np.float32)]
        out[f"scale{caffe_suffix}"] = [_np(state_dict[f"{prefix}.weight"]), _np(state_dict[f"{prefix}.bias"])]

    out["conv1"] = [_np(state_dict["conv1.weight"])]
    put_bn("bn1", "_conv1")
    for s, n_blocks in enumerate(stage_blocks, start=2):
        for b, blk in enumerate(caffe_block_names(n_blocks)):
            mod = f"res{s}_{b}"
            for name, br in RESNET_CONV_BRANCH.items():
                if f"{mod}.{name}.weight" in state_dict:
                    out[f"res{s}{blk}_branch{br}"] = [_np(state_dict[f"{mod}.{name}.weight"])]
            for name, br in RESNET_BN_BRANCH.items():
                if f"{mod}.{name}.running_mean" in state_dict:
                    put_bn(f"{mod}.{name}", f"{s}{blk}_branch{br}")
    for key, t in state_dict.items():
        layer, kind = key.rsplit(".", 1)
        if layer.startswith("fc1_voc12_c") and kind == "weight":
            out[layer] = [_np(t), _np(state_dict[f"{layer}.bias"])]
    return out
