"""Graph IR for quantized inference graphs (numpy only).

A copy of ``yoloface_tpu.graph.ir``: that package imports jax as soon as any
of its modules is imported, and the port must run where jax is absent.
``yoloface_tpu_torch.convert.graph_from_jax`` turns the JAX package's
``GraphDef`` into this one field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class QParams:
    """Per-tensor (or per-channel) affine quantization parameters.

    value_float = scale * (value_int - zero_point)

    Mirrors TFLite ``QuantizationParameters`` and the reference's
    ``AI_INTQ_INFO_LIST_OBJ_DECLARE`` tables (network.c:665+).
    """

    scales: Tuple[float, ...]            # len 1 = per-tensor
    zero_points: Tuple[int, ...]
    quantized_dimension: int = 0

    @property
    def per_tensor(self) -> bool:
        return len(self.scales) == 1

    @property
    def scale(self) -> float:
        assert self.per_tensor, "per-channel qparams have no single scale"
        return self.scales[0]

    @property
    def zero_point(self) -> int:
        assert self.per_tensor
        return self.zero_points[0]


@dataclasses.dataclass
class TensorDef:
    """One tensor in the graph (activation or constant)."""

    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    qparams: Optional[QParams] = None
    data: Optional[np.ndarray] = None    # constants (weights/bias/pad values)

    @property
    def is_const(self) -> bool:
        return self.data is not None


@dataclasses.dataclass
class OpDef:
    """One operator: a TFLite builtin with resolved attributes."""

    index: int
    opname: str                          # e.g. "CONV_2D"
    inputs: List[int]                    # tensor indices (-1 = absent)
    outputs: List[int]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GraphDef:
    """A whole (sub)graph: the unit the runtime engine compiles."""

    tensors: List[TensorDef]
    ops: List[OpDef]
    inputs: List[int]
    outputs: List[int]
    name: str = "main"
    description: str = ""

    def tensor(self, idx: int) -> TensorDef:
        return self.tensors[idx]

    def summary(self) -> str:
        lines = [f"graph {self.name!r}: {len(self.ops)} ops, "
                 f"{len(self.tensors)} tensors, in={self.inputs} out={self.outputs}"]
        for op in self.ops:
            ins = ", ".join(
                f"{i}:{tuple(self.tensors[i].shape)}" for i in op.inputs if i >= 0)
            outs = ", ".join(
                f"{o}:{tuple(self.tensors[o].shape)}" for o in op.outputs)
            lines.append(f"  [{op.index:3d}] {op.opname:<20s} ({ins}) -> ({outs}) {op.attrs}")
        return "\n".join(lines)
