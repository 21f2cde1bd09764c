"""C-style inference API facade: signature parity with the reference.

The counterpart of ``yoloface_tpu.runtime.api``.  Mirrors the X-CUBE-AI
entry points (``stm32/X-CUBE-AI/App/network.h:103-213``) for users porting
MCU call sites:

    network = ai_network_create()                      # network.c:3372
    ai_network_init(network, weights="model.tflite")   # network.c:3386
    ai_network_run(network, in_data, out_data)         # network.c:3406
    report = ai_network_get_report(network)            # network.c:3350
    err = ai_network_get_error(network)                # network.c:3364
    ai_network_destroy(network)

Errors are recorded as (type, code) pairs like ``ai_error`` instead of
raising, matching the reference's error model (yoloface.c:193-207).  The
engine is the port's ``Int8Engine`` in one of its modes
(``runtime.engine.MODES``), on the card unless ``ai_network_init`` is
given ``device="cpu"``; ``ai_network_run`` takes and returns numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

AI_ERROR_NONE = (0, 0)
AI_ERROR_INIT_FAILED = (1, 1)
AI_ERROR_INVALID_INPUT = (2, 1)
AI_ERROR_RUN_FAILED = (3, 1)


@dataclasses.dataclass
class AiNetwork:
    engine: Optional[object] = None
    error: Tuple[int, int] = AI_ERROR_NONE
    n_batches: int = 0


def ai_network_create() -> AiNetwork:
    return AiNetwork()


def ai_network_init(network: AiNetwork, weights: str, mode: str = "exact",
                    device="cuda") -> bool:
    """weights: path to an int8 .tflite (the weights+activations params of
    the reference's init call travel inside the flatbuffer here)."""
    try:
        from yoloface_tpu_torch.io.tflite_import import load_tflite
        from yoloface_tpu_torch.runtime.engine import Int8Engine
        network.engine = Int8Engine(load_tflite(weights), mode=mode,
                                    device=device)
        network.error = AI_ERROR_NONE
        return True
    except Exception:
        network.error = AI_ERROR_INIT_FAILED
        return False


def _host(y):
    """The engine's output (a tensor, or a tuple of them for a graph with
    several outputs) as numpy."""
    if isinstance(y, tuple):
        return tuple(t.cpu().numpy() for t in y)
    return y.cpu().numpy()


def ai_network_run(network: AiNetwork, in_data: np.ndarray,
                   out_data: Optional[np.ndarray] = None) -> int:
    """Returns the number of batches processed (like the C API); 0 on
    error.  If ``out_data`` is given, results are written into it."""
    if network.engine is None:
        network.error = AI_ERROR_INIT_FAILED
        return 0
    try:
        y = np.asarray(_host(network.engine(np.asarray(in_data))))
    except (ValueError, TypeError):
        network.error = AI_ERROR_INVALID_INPUT
        return 0
    except Exception:
        network.error = AI_ERROR_RUN_FAILED
        return 0
    if out_data is not None:
        out_data[...] = y
    network.n_batches += y.shape[0]
    network.error = AI_ERROR_NONE
    return y.shape[0]


def ai_network_get_error(network: AiNetwork) -> Tuple[int, int]:
    return network.error


def ai_network_get_report(network: AiNetwork) -> dict:
    """The ai_network_get_report analogue (network.c:3350): model geometry
    and counters."""
    if network.engine is None:
        return {"initialized": False}
    g = network.engine.graph
    from yoloface_tpu_torch.runtime.profiler import macc_per_op
    return {
        "initialized": True,
        "n_ops": len(g.ops),
        "n_tensors": len(g.tensors),
        "input_shape": [1, *network.engine.input_shape],
        "output_shape": list(g.tensor(g.outputs[0]).shape),
        "macc_per_frame_conv": int(sum(macc_per_op(g).values())),
        "n_batches_processed": network.n_batches,
        "mode": network.engine.mode,
    }


def ai_network_destroy(network: AiNetwork) -> None:
    network.engine = None
    network.error = AI_ERROR_NONE
