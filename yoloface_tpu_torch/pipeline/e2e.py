"""Camera frames -> detections: the port's serving path.

The counterpart of ``yoloface_tpu.pipeline.e2e``.  With a kernel engine
(``arena2``, ``arena``, ``arena_exact``; ``fused``, ``fused_exact``;
``perop``, ``perop_exact``; the ``tiled*`` modes) ``detect_rgb565`` runs
three kernels on the card: the RGB565 preprocess, the arena stage(s),
fused stages, per-op launches or tiled sections of the int8 net and the
fused head (or, with
``HeadConfig(use_fused_head=False)``, the top-K kernel and the staged
decode and NMS), as the JAX pipeline routes every ``pallas*`` mode through
its preprocess kernel.  On the CPU the same calls take each kernel's plain
torch version.  No batch padding: any N works.

``load_pipeline`` defaults to ``arena2`` (fast2 bits, the serving mode) on
the card (``device="cpu"`` runs the plain versions); the JAX package's
engine and ``load_pipeline`` default to ``exact``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from yoloface_tpu_torch.kernels.preprocess import preprocess_rgb565
from yoloface_tpu_torch.pipeline import head as head_lib
from yoloface_tpu_torch.pipeline.head import HeadConfig
from yoloface_tpu_torch.pipeline.preprocess import rgb565_to_int8_input
from yoloface_tpu_torch.runtime.engine import KERNEL_MODES, Int8Engine


class FacePipeline(nn.Module):
    """Batched camera-frames -> detections pipeline around an Int8Engine."""

    def __init__(self, engine: Int8Engine,
                 head_config: Optional[HeadConfig] = None):
        super().__init__()
        self.engine = engine
        self.head_config = head_config or HeadConfig()
        oq = engine.output_qparams
        self._out_scale = float(oq.scale)
        self._out_zp = int(oq.zero_point)

    @property
    def device(self) -> torch.device:
        return self.engine._device()

    def _head(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, s, v = head_lib.detect_int8_head(
            y, scale=self._out_scale, zero_point=self._out_zp,
            cfg=self.head_config)
        return {"boxes": b, "scores": s, "valid": v,
                "count": v.sum(-1, dtype=torch.int32)}

    def _on_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device).contiguous()

    @torch.no_grad()
    def detect_int8(self, x_int8) -> Dict[str, torch.Tensor]:
        """int8 network inputs [N,56,56,3] -> detections dict."""
        return self._head(self.engine(self._on_device(x_int8)))

    @torch.no_grad()
    def preprocess(self, frames) -> torch.Tensor:
        """uint16 RGB565 [N,112,112] -> int8 [N,56,56,3] on the device."""
        f = self._on_device(frames)
        if self.engine.mode in KERNEL_MODES:
            return preprocess_rgb565(f)
        return rgb565_to_int8_input(f)

    @torch.no_grad()
    def detect_rgb565(self, frames) -> Dict[str, torch.Tensor]:
        """uint16 RGB565 camera frames [N,112,112] -> detections dict on
        the pipeline's device.  Keys: boxes [N,K,4] xyxy in the 56x56
        frame, scores [N,K], valid [N,K] bool, count [N] int32."""
        return self._head(self.engine(self.preprocess(frames)))


def load_pipeline(tflite_path: str, mode: str = "arena2", device="cuda",
                  head_config: Optional[HeadConfig] = None) -> FacePipeline:
    """Path to an int8 .tflite -> ready FacePipeline on ``device``."""
    from yoloface_tpu_torch.io.tflite_import import load_tflite
    return FacePipeline(Int8Engine(load_tflite(tflite_path), mode, device),
                        head_config)
