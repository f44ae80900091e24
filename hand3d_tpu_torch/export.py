"""AOT export: the cascade as one self-describing deployment artifact
(counterpart of hand3d_tpu/export.py).

``export_estimator`` traces the full inference cascade once with
``torch.export``, with the weights baked in as constants, and writes the
JAX package's container around the program:

    b"H3DX"            magic
    u32 little-endian  JSON header length
    JSON header        {"version", "format": "torch.export", "batch_size",
                        "input_hw", "left_hand", "seg_scale", "quantize",
                        "phase_pack", "compute_dtype", "device", "torch"}
    payload            torch.export.save bytes of the ExportedProgram

Both hand-written kernels are in the program as the registered ops
``torch.ops.hand3d.flood_fill`` and ``torch.ops.hand3d.decode_upsampled``
(``ops/kernels``). With ``quantize="int8"`` the int8 weights and their
scales are baked in, and each int8 conv is the registered op
``torch.ops.hand3d.int8_conv`` (``ops/quant``), which allows TF32 for its
own call only, as the live estimator does. With ``phase_pack=True`` the
phase-packed conv1_2 layers and their fused pools are traced in. The
program maps f32[B, H, W, 3] to the dict of
``serving.HandPoseEstimator.predict``; shapes are static, one artifact per
(batch, height, width) bucket. The program's input stays normalized
float32: ``ExportedEstimator`` normalizes uint8 frames on the device before
the program (``batching.to_device_normalized``), float frames on the host.

A loading host needs torch, numpy and the port's kernel ops (built from
``csrc/`` by nvcc at first use on a card): ``ExportedEstimator`` imports no
model code and reads no weight file. The program is loaded on the device it
was exported for.
"""

import contextlib
import io
import json
import struct

import numpy as np
import torch

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.batching import (check_input, chunked_predict,
                                       predict_input, select_serving_outputs,
                                       to_device_normalized, uint8_levels)

_MAGIC = b"H3DX"
ARTIFACT_VERSION = 1
FORMAT = "torch.export"


class _Cascade(torch.nn.Module):
    """The served cascade as a module whose forward takes only the image;
    params and hand side are plain attributes, so export bakes them in."""

    def __init__(self, net, params, hand_side):
        super().__init__()
        self.net, self.params, self.hand_side = net, params, hand_side

    def forward(self, image):
        return select_serving_outputs(self.net.inference(
            self.params, image, self.hand_side, keypoints_scoremap=False))


def export_estimator(params, path=None, *, batch_size=16, input_hw=(240, 320),
                     left_hand=True, compute_dtype=None, seg_scale=1.0,
                     quantize=None, phase_pack=False, device="cuda"):
    """Serialize the full cascade (weights baked in) to a deployment artifact.

    ``params``: TF-layout param tree (e.g. ``weights.load_npz(...)``).
    ``device``: where the program runs ("cuda": the CUDA kernels; "cpu":
    their twins); the artifact is loaded there. ``quantize``: None or
    "int8" (dynamic activation scales, ``serving.prepare_params``), the
    int8 tree made on ``device``. ``phase_pack``: conv1_2 phase-packed
    after any quantization (``serving.prepare_params``); the input width
    must be even.

    Returns the artifact bytes; also writes them to ``path`` if given.
    """
    from hand3d_tpu_torch.models.cascade import (ColorHandPose3D,
                                                 compute_dtype_of)
    from hand3d_tpu_torch.serving import (hand_side_tensor,
                                          quantized_device_params)

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    device = precision.exact_f32(device)
    net = ColorHandPose3D(compute_dtype=compute_dtype, seg_scale=seg_scale)
    module = _Cascade(net, quantized_device_params(
        params, device, quantize, phase_pack=phase_pack),
        hand_side_tensor(left_hand, batch_size, device))
    image = torch.zeros((batch_size, *input_hw, 3), device=device)
    program = torch.export.export(module, (image,))
    payload = io.BytesIO()
    torch.export.save(program, payload)
    header = {
        "version": ARTIFACT_VERSION,
        "format": FORMAT,
        "batch_size": int(batch_size),
        "input_hw": [int(x) for x in input_hw],
        "left_hand": bool(left_hand),
        "seg_scale": float(seg_scale),
        "quantize": quantize,
        "phase_pack": bool(phase_pack),
        "compute_dtype": "bfloat16" if compute_dtype_of(compute_dtype)
        else None,
        "device": str(device),
        "torch": torch.__version__,
    }
    head = json.dumps(header).encode("utf-8")
    blob = _MAGIC + struct.pack("<I", len(head)) + head + payload.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ExportedEstimator:
    """A loaded deployment artifact with the serving predict() contract.

    Needs torch, numpy and the port's kernel ops at load time: no model
    code, no weight files.
    """

    def __init__(self, blob):
        if not blob.startswith(_MAGIC):
            raise ValueError("not a hand3d-tpu export artifact (bad magic)")
        (hlen,) = struct.unpack_from("<I", blob, len(_MAGIC))
        off = len(_MAGIC) + 4
        self.meta = json.loads(blob[off:off + hlen].decode("utf-8"))
        if self.meta.get("format") != FORMAT:
            raise ValueError(
                "a JAX artifact of hand3d_tpu.export (StableHLO payload, "
                f"platforms {self.meta.get('platforms')}): load it with "
                "hand3d_tpu.export.ExportedEstimator; the PyTorch port reads "
                "torch.export artifacts of hand3d_tpu_torch.export")
        if self.meta["version"] != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {self.meta['version']} != "
                             f"supported {ARTIFACT_VERSION}")
        # registers torch.ops.hand3d.*, which the program calls
        import hand3d_tpu_torch.ops.kernels  # noqa: F401
        import hand3d_tpu_torch.ops.quant  # noqa: F401

        # the TF32 flags are process state, not part of the program
        self.device = precision.exact_f32(self.meta["device"])
        self.compute_dtype = self.meta["compute_dtype"]
        self.batch_size = self.meta["batch_size"]
        self.input_hw = tuple(self.meta["input_hw"])
        self.levels = uint8_levels(self.device)
        program = torch.export.load(io.BytesIO(blob[off + hlen:]))
        self._fwd = program.module()

    @classmethod
    def load(cls, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            return cls(bytes(path_or_bytes))
        with open(path_or_bytes, "rb") as f:
            return cls(f.read())

    def _run(self, chunk):
        # the bf16 program's convolutions take rounded operands: TF32 is
        # exact for them (precision.tf32_convs); cuBLAS stays f32
        scope = (precision.tf32_convs(self.device)
                 if self.compute_dtype == "bfloat16"
                 else contextlib.nullcontext())
        image = to_device_normalized(chunk, self.levels)
        with torch.inference_mode(), scope:
            return self._fwd(image)

    def warmup(self):
        """Run one batch of uint8 frames ahead of traffic (kernel build,
        cuDNN set-up, the normalize on the device)."""
        self.predict(np.zeros((self.batch_size, *self.input_hw, 3),
                              np.uint8))
        return self

    def predict(self, images, *, normalized=False):
        """Same contract as serving.HandPoseEstimator.predict: [N,H,W,3]
        uint8 / [0,1] float / mean-subtracted float in, dict of numpy out.
        uint8 frames are normalized on the device, chunk by chunk; float
        frames on the host."""
        images = predict_input(images, normalized)
        check_input(images, self.input_hw)
        return chunked_predict(self._run, images, self.batch_size)
