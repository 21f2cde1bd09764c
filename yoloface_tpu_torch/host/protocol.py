"""The detection text protocol: encoder + parser.

Wire-format parity with the firmware's UART output
(`stm32/User/main.c:44,51` and `stm32/X-CUBE-AI/App/yoloface.c:148`):

    === Frame N ===\r\n
    ----------------------------------------\r\n
    [Face i] BBox: [x1, y1, x2, y2], Conf: c.cc\r\n   (per face)
    ----------------------------------------\r\n
    [INFO] Total faces detected: n\r\n

and parser parity with the host GUI's regexes
(`上位机/IAP/main.py:317-369`), including its tolerance for partial frames.
Coordinates are in the 2x-scaled 112x112 display space like the firmware
(box * 2, yoloface.c:147-148).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, List, Tuple

RULE = "-" * 40

_FRAME_RE = re.compile(r"=== Frame (\d+) ===")
_FACE_RE = re.compile(
    r"\[Face\s+(\d+)\]\s+BBox:\s*\[(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\],"
    r"\s*Conf:\s*([\d\.]+)")
_TOTAL_RE = re.compile(r"Total faces detected:\s*(\d+)", re.IGNORECASE)


@dataclasses.dataclass
class Face:
    id: int
    x1: int
    y1: int
    x2: int
    y2: int
    confidence: float

    @property
    def width(self) -> int:
        return self.x2 - self.x1

    @property
    def height(self) -> int:
        return self.y2 - self.y1


@dataclasses.dataclass
class Frame:
    number: int
    faces: List[Face]
    total: int


def encode_frame(frame_num: int, boxes, scores, valid,
                 scale: int = 2) -> str:
    """Detections (pipeline output for ONE frame, 56x56 space) -> protocol
    text.  ``scale`` maps to the 112x112 display like the firmware's *2."""
    lines = [f"=== Frame {frame_num} ===", RULE]
    n = 0
    for box, conf, ok in zip(boxes, scores, valid):
        if not ok:
            continue
        n += 1
        x1, y1, x2, y2 = (int(v) * scale for v in box)
        lines.append(
            f"[Face {n}] BBox: [{x1}, {y1}, {x2}, {y2}], Conf: {conf:.2f}")
    lines += [RULE, f"[INFO] Total faces detected: {n}"]
    return "\r\n".join(lines) + "\r\n"


def parse_frame(data_lines: Iterable[str]) -> Frame:
    """Port of ``parse_frame_data`` (main.py:317-369): regex scan over the
    buffered lines of one frame."""
    faces: List[Face] = []
    frame_num = 0
    total = 0
    for line in data_lines:
        m = _FRAME_RE.search(line)
        if m:
            frame_num = int(m.group(1))
        m = _FACE_RE.search(line)
        if m:
            faces.append(Face(int(m.group(1)), int(m.group(2)),
                              int(m.group(3)), int(m.group(4)),
                              int(m.group(5)), float(m.group(6))))
        m = _TOTAL_RE.search(line)
        if m:
            total = int(m.group(1))
    if total == 0 and faces:
        total = len(faces)
    return Frame(frame_num, faces, total)


class StreamParser:
    """Incremental line-buffered parser (the RX-thread + queue behavior of
    main.py:281-311/371-399): feed raw text chunks, yields complete Frames
    when the 'Total faces detected' terminator arrives; tolerates partial
    chunks and noise lines."""

    def __init__(self):
        self._buf = ""
        self._lines: List[str] = []

    def feed(self, chunk: str) -> List[Frame]:
        frames: List[Frame] = []
        self._buf += chunk
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip("\r")
            if not line:
                continue
            self._lines.append(line)
            if _TOTAL_RE.search(line):
                frames.append(parse_frame(self._lines))
                self._lines = []
        return frames
