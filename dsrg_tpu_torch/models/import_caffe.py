"""``.caffemodel`` import without Caffe or a protobuf schema
(``dsrg_tpu/models/import_caffe.py``, the port's own copy).

The reference warm-starts from a ``.caffemodel`` through ``net.copy_from``
(``run.sh:5``).  The file is read at the protobuf wire level:

  NetParameter: name=1 (string), layers=2 (repeated V1LayerParameter),
                layer=100 (repeated LayerParameter)
  LayerParameter:   name=1, type=2 (string), blobs=7 (repeated BlobProto)
  V1LayerParameter: name=4, type=5 (enum),   blobs=6
  BlobProto: num/channels/height/width = 1..4 (int32),
             data=5 (packed float), shape=7 (BlobShape: dim=1 packed int64),
             double_data=9

Caffe's convolution weights are (out, in, kh, kw), torch's layout, so they
load as they are.  Channels stay BGR: the data pipeline feeds BGR as
Caffe's does.  Layers missing from the file keep the template's values
(``net.copy_from``); an array whose shape differs from the template's is
reported and skipped.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_LEN = 2
_WIRE_FIXED32 = 5

# a bottleneck's convolutions / batch norms -> the Caffe branch suffix
RESNET_CONV_BRANCH = {"conv1": "2a", "conv2": "2b", "conv3": "2c", "shortcut": "1"}
RESNET_BN_BRANCH = {"bn1": "2a", "bn2": "2b", "bn3": "2c", "shortcut_bn": "1"}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_FIXED64:
            val, pos = buf[pos: pos + 8], pos + 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos: pos + ln], pos + ln
        elif wire == _WIRE_FIXED32:
            val, pos = buf[pos: pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    dims_old = {}
    shape: Optional[List[int]] = None
    parts: List[np.ndarray] = []
    for field, wire, val in _iter_fields(buf):
        if field in (1, 2, 3, 4) and wire == _WIRE_VARINT:
            dims_old[field] = val
        elif field == 5:  # data: packed, or one fixed32 per field
            parts.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field == 7 and wire == _WIRE_LEN:  # BlobShape
            shape = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 != 1:
                    continue
                if w2 == _WIRE_LEN:  # packed int64
                    pos = 0
                    while pos < len(v2):
                        d, pos = _read_varint(v2, pos)
                        shape.append(d)
                else:
                    shape.append(v2)
        elif field == 9 and wire == _WIRE_LEN:  # double_data
            parts.append(np.frombuffer(bytes(val), dtype="<f8").astype(np.float32))
    data = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    if shape is None and dims_old:
        shape = [dims_old.get(i, 1) for i in (1, 2, 3, 4)]
    return data.reshape(shape) if shape else data


def _parse_layer(buf: memoryview, v1: bool) -> Tuple[str, List[np.ndarray]]:
    name_field, blob_field = (4, 6) if v1 else (1, 7)
    name, blobs = "", []
    for field, wire, val in _iter_fields(buf):
        if field == name_field and wire == _WIRE_LEN:
            name = bytes(val).decode("utf-8", errors="replace")
        elif field == blob_field and wire == _WIRE_LEN:
            blobs.append(_parse_blob(val))
    return name, blobs


def load_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel into ``{layer_name: [blob arrays]}`` (layers with blobs only)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: Dict[str, List[np.ndarray]] = {}
    for field, wire, val in _iter_fields(buf):
        if wire == _WIRE_LEN and field in (2, 100):  # layers (V1) / layer
            name, blobs = _parse_layer(val, v1=field == 2)
            if blobs:
                out[name] = blobs
    return out


def caffe_block_names(n_blocks: int) -> List[str]:
    """DeepLab-v2 ResNet block suffixes: stages of up to 3 blocks use
    a/b/c, longer ones a/b1/b2/... (res3a..res3b3, res4a..res4b22)."""
    if n_blocks <= 3:
        return ["abc"[i] for i in range(n_blocks)]
    return ["a"] + [f"b{i}" for i in range(1, n_blocks)]


class _Loader:
    """Arrays of a template state_dict replaced where name and shape match."""

    def __init__(self, template: Mapping[str, torch.Tensor]):
        self.out = dict(template)

    def put(self, key: str, value: np.ndarray, what: str) -> None:
        if key not in self.out:
            return
        want = tuple(self.out[key].shape)
        if value.shape != want:
            print(f"import_caffe: {what} shape {value.shape} != {want}, skipping")
            return
        self.out[key] = torch.from_numpy(np.array(value, np.float32))

    def conv(self, prefix: str, blobs: List[np.ndarray]) -> None:
        self.put(f"{prefix}.weight", blobs[0], f"{prefix} kernel")
        if len(blobs) >= 2:
            self.put(f"{prefix}.bias", blobs[1].reshape(-1), f"{prefix} bias")


def caffe_blobs_to_torch(blobs: Mapping[str, List[np.ndarray]], state_dict: Mapping[str, torch.Tensor]) -> dict:
    """VGG16-LargeFOV: Caffe layer blobs onto a state_dict by layer name
    (counterpart of ``caffe_blobs_to_flax``); ``fc8`` naming variants across
    the reference's snapshots ("fc8-SEC_k", "fc8_k") match loosely.
    Returns the merged state_dict."""
    alias = {}
    for name in blobs:
        alias[name] = name
        if name.startswith("fc8") and "-" in name:
            alias[name.replace("fc8-SEC", "fc8")] = name
    load = _Loader(state_dict)
    for layer in dict.fromkeys(key.rsplit(".", 1)[0] for key in state_dict):
        if layer in alias:
            load.conv(layer, blobs[alias[layer]])
    return load.out


def resnet_blobs_to_torch(blobs: Mapping[str, List[np.ndarray]], state_dict: Mapping[str, torch.Tensor],
                          stage_blocks=(3, 4, 23, 3)) -> dict:
    """A DeepLab-v2 ResNet-101 caffemodel onto a ``ResNet101DeepLab``
    state_dict (counterpart of ``resnet_blobs_to_flax``).

    Caffe names: convolutions ``conv1`` / ``res{S}{blk}_branch{2a,2b,2c}``
    and the projection ``res{S}{blk}_branch1``; BatchNorm layers
    ``bn_conv1`` / ``bn{S}{blk}_branch...`` with blobs [mean*sf, var*sf, sf]
    (the running statistics); Scale layers ``scale_conv1`` / ``scale...``
    with [gamma, beta] (the BN's ``weight`` / ``bias``); heads
    ``fc1_voc12_c{k}``.  Returns the merged state_dict, buffers included."""
    load = _Loader(state_dict)

    def conv(prefix, caffe_name):
        if caffe_name in blobs:
            load.conv(prefix, blobs[caffe_name])

    def bn(prefix, caffe_suffix):
        stats = blobs.get(f"bn{caffe_suffix}")
        if stats is not None:
            sf = float(stats[2].reshape(-1)[0]) if len(stats) >= 3 else 1.0
            sf = sf if sf != 0.0 else 1.0
            load.put(f"{prefix}.running_mean", np.asarray(stats[0].reshape(-1) / sf, np.float32),
                     f"bn{caffe_suffix} mean")
            load.put(f"{prefix}.running_var", np.asarray(stats[1].reshape(-1) / sf, np.float32),
                     f"bn{caffe_suffix} var")
        scale = blobs.get(f"scale{caffe_suffix}")
        if scale is not None:
            load.put(f"{prefix}.weight", scale[0].reshape(-1), f"scale{caffe_suffix} gamma")
            if len(scale) >= 2:
                load.put(f"{prefix}.bias", scale[1].reshape(-1), f"scale{caffe_suffix} beta")

    conv("conv1", "conv1")
    bn("bn1", "_conv1")
    for s, n_blocks in enumerate(stage_blocks, start=2):
        for b, blk in enumerate(caffe_block_names(n_blocks)):
            for name, br in RESNET_CONV_BRANCH.items():
                conv(f"res{s}_{b}.{name}", f"res{s}{blk}_branch{br}")
            for name, br in RESNET_BN_BRANCH.items():
                bn(f"res{s}_{b}.{name}", f"{s}{blk}_branch{br}")
    for layer in dict.fromkeys(key.rsplit(".", 1)[0] for key in state_dict):
        if layer.startswith("fc1_voc12_c"):
            conv(layer, layer)
    return load.out
