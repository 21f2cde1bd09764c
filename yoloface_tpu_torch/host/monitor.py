"""Terminal detection monitor — the host-PC dashboard.

Re-implements the capabilities of the reference's Tkinter GUI
(`上位机/IAP/main.py`: FaceDetectionMonitor) for a headless environment:
protocol-stream parsing, per-frame face table, rolling history, session
statistics, and an ASCII render of the detection boxes on the 112x112
display space (the GUI's "模拟显示" canvas, main.py:474-552).  Sources:
live in-process camera emulation, a protocol text file, or stdin (the
serial-port analogue).

The counterpart of ``yoloface_tpu.host.monitor``; its live sources
(``--source synthetic|dataset``) run the port's ``CameraStreamer`` on
``--device`` (the card by default; ``cpu`` runs every kernel's plain
version) through ``load_pipeline(tflite, mode="arena_exact")``, the bits
of the JAX package's default ``exact`` pipeline on the kernels.

Run: ``python -m yoloface_tpu_torch.host.monitor --source synthetic
--batches 4``
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Deque, Optional

from yoloface_tpu_torch.host import protocol

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TFLITE = os.path.join(REPO, "checkpoints",
                              "yoloface_corpus_int8.tflite")
DEFAULT_DATASET = os.path.join(REPO, "checkpoints", "vis")


class MonitorState:
    """Session statistics mirroring the GUI's counters (main.py:36-48,
    442-472): current faces, total frames, total faces, rolling history."""

    def __init__(self, history_len: int = 50):
        self.frames = 0
        self.total_faces = 0
        self.last_frame: Optional[protocol.Frame] = None
        self.history: Deque[int] = collections.deque(maxlen=history_len)

    def update(self, frame: protocol.Frame):
        self.frames += 1
        self.total_faces += frame.total
        self.last_frame = frame
        self.history.append(frame.total)

    # ------------------------------------------------------------- display
    def face_table(self) -> str:
        if not self.last_frame or not self.last_frame.faces:
            return "  (no faces)"
        rows = [f"  #{f.id}  [{f.x1:3d},{f.y1:3d},{f.x2:3d},{f.y2:3d}]"
                f"  {f.width:3d}x{f.height:<3d}  conf={f.confidence:.2f}"
                for f in self.last_frame.faces]
        return "\n".join(rows)

    def sparkline(self) -> str:
        """Rolling face-count history as a unicode sparkline (the GUI's
        matplotlib chart, main.py:448-472)."""
        if not self.history:
            return ""
        blocks = " ▁▂▃▄▅▆▇█"
        hi = max(max(self.history), 1)
        return "".join(blocks[min(int(v / hi * 8), 8)] for v in self.history)

    def ascii_canvas(self, w: int = 56, h: int = 28) -> str:
        """Detection boxes on a w x h character canvas scaled from the
        112x112 display space."""
        grid = [[" "] * w for _ in range(h)]
        if self.last_frame:
            for f in self.last_frame.faces:
                x1 = max(0, min(w - 1, f.x1 * w // 112))
                x2 = max(0, min(w - 1, f.x2 * w // 112))
                y1 = max(0, min(h - 1, f.y1 * h // 112))
                y2 = max(0, min(h - 1, f.y2 * h // 112))
                for x in range(x1, x2 + 1):
                    grid[y1][x] = grid[y2][x] = "#"
                for y in range(y1, y2 + 1):
                    grid[y][x1] = grid[y][x2] = "#"
        return "\n".join("|" + "".join(row) + "|" for row in grid)

    def render(self) -> str:
        f = self.last_frame
        head = (f"Frame {f.number}: {f.total} face(s)"
                if f else "waiting for frames…")
        return "\n".join([
            head,
            self.face_table(),
            f"history: {self.sparkline()}",
            f"session: {self.frames} frames, {self.total_faces} faces total",
        ])

    def summary(self) -> dict:
        return {"frames": self.frames, "total_faces": self.total_faces,
                "avg_faces": (self.total_faces / self.frames
                              if self.frames else 0.0)}

    def render_png(self, path: str, display: int = 112) -> None:
        """Rendered dashboard image — the graphical twin of the reference
        GUI's live view: the scaled box-render canvas (main.py:474-552)
        next to the rolling face-count history chart (main.py:448-472).
        Written from the live monitor loop via ``--save-png`` so headless
        runs still produce the GUI's visual artifact."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import patches

        fig, (ax_c, ax_h) = plt.subplots(
            1, 2, figsize=(8, 4),
            gridspec_kw={"width_ratios": [1, 1.2]})
        f = self.last_frame
        ax_c.set_title(f"frame {f.number}: {f.total} face(s)"
                       if f else "waiting for frames")
        ax_c.set_xlim(0, display)
        ax_c.set_ylim(display, 0)                 # image coordinates
        ax_c.set_aspect("equal")
        ax_c.set_facecolor("#202020")
        if f:
            for face in f.faces:
                ax_c.add_patch(patches.Rectangle(
                    (face.x1, face.y1), face.width, face.height,
                    linewidth=1.5, edgecolor="#00ff66", facecolor="none"))
                ax_c.text(face.x1, max(face.y1 - 2, 2),
                          f"#{face.id} {face.confidence:.2f}",
                          color="#00ff66", fontsize=7)
        hist = list(self.history)
        # frames are numbered 1-based in the protocol: the last history
        # point belongs to frame `self.frames`, not `self.frames - 1`
        ax_h.plot(range(self.frames - len(hist) + 1, self.frames + 1),
                  hist, marker="o", markersize=3, linewidth=1)
        ax_h.set_title("face-count history")
        ax_h.set_xlabel("frame")
        ax_h.set_ylabel("faces")
        ax_h.set_ylim(bottom=0)
        fig.suptitle(f"session: {self.frames} frames, "
                     f"{self.total_faces} faces")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)


def _render_point(state: MonitorState, render_every: int, out,
                  draw_canvas: bool, save_png: Optional[str]) -> None:
    """One per-frame render decision + output (shared by every source so
    the cadence / canvas / PNG-naming logic cannot drift between the
    stream monitor and the live camera loop)."""
    if state.frames % render_every != 0:
        return
    print(state.render(), file=out)
    if draw_canvas:
        print(state.ascii_canvas(), file=out)
    print("-" * 40, file=out)
    if save_png:
        state.render_png(os.path.join(
            save_png, f"frame_{state.frames:05d}.png"))


def run_monitor(stream, render_every: int = 1, out=sys.stdout,
                draw_canvas: bool = False,
                save_png: Optional[str] = None) -> MonitorState:
    """Consume protocol text chunks from an iterable; render to ``out``.
    ``save_png``: directory that receives a rendered dashboard image
    (boxes + history chart) at every render point."""
    state = MonitorState()
    parser = protocol.StreamParser()
    if save_png:
        os.makedirs(save_png, exist_ok=True)
    for chunk in stream:
        for frame in parser.feed(chunk):
            state.update(frame)
            _render_point(state, render_every, out, draw_canvas, save_png)
    return state


def socket_stream(host: str = "127.0.0.1", port: int = 8765,
                  listen: bool = False, timeout: Optional[float] = None):
    """Byte-stream transport: yield protocol text chunks from a TCP
    connection — the serial-port role of the reference GUI
    (`上位机/IAP/main.py:228-311` connect_serial + receive_data thread;
    pyserial is absent in this environment, so a socket is the honest
    byte-stream equivalent).  ``listen=True`` binds and accepts one
    producer (firmware-side analogue pushes the UART text in); otherwise
    connects as a client.  Terminates on EOF."""
    import socket as socketlib

    if listen:
        srv = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
        srv.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        if timeout is not None:
            srv.settimeout(timeout)
        conn, _ = srv.accept()
        srv.close()
    else:
        conn = socketlib.create_connection((host, port), timeout=timeout)
    if timeout is not None:
        conn.settimeout(timeout)
    try:
        while True:
            data = conn.recv(4096)
            if not data:
                return
            yield data.decode("utf-8", errors="replace")
    finally:
        conn.close()


def load_config(path: str) -> dict:
    """Persisted monitor defaults — the GUI's JSON config
    (main.py:585-613, serial_config.json analogue)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def save_config(path: str, cfg: dict) -> None:
    try:
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
    except OSError:
        pass


def main(argv=None):
    p = argparse.ArgumentParser(description="yoloface detection monitor")
    p.add_argument("--config", default="monitor_config.json",
                   help="JSON defaults file (persisted on exit)")
    p.add_argument("--source", choices=["stdin", "file", "synthetic",
                                        "dataset", "socket"])
    p.add_argument("--file", help="protocol text file (--source file)")
    p.add_argument("--host", default="127.0.0.1",
                   help="TCP host (--source socket)")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--listen", action="store_true",
                   help="bind and accept the producer instead of connecting")
    p.add_argument("--dataset")
    p.add_argument("--batches", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--render-every", type=int)
    p.add_argument("--canvas", action="store_true", default=None)
    p.add_argument("--save-png", dest="save_png", metavar="DIR",
                   help="write a rendered dashboard PNG (boxes + history "
                        "chart) at every render point")
    p.add_argument("--tflite")
    p.add_argument("--device", default="cuda",
                   help="where the live sources run the pipeline (cuda, or "
                        "cpu for the kernels' plain versions)")
    p.add_argument("--gui", action="store_true",
                   help="interactive Tkinter dashboard (host/gui.py — "
                        "the reference GUI twin); falls back to the "
                        "headless loop when no display is available")
    args = p.parse_args(argv)

    if args.gui:
        from yoloface_tpu_torch.host.gui import run_gui
        if run_gui(args.config):
            return
        # no display: continue into the terminal loop below

    defaults = {"source": "stdin", "batches": 4, "batch_size": 8,
                "render_every": 1, "canvas": False,
                "dataset": DEFAULT_DATASET, "tflite": DEFAULT_TFLITE}
    defaults.update(load_config(args.config))
    for key, val in defaults.items():
        if getattr(args, key, None) is None:
            setattr(args, key, val)
    save_config(args.config, {
        "source": args.source, "batches": args.batches,
        "batch_size": args.batch_size, "render_every": args.render_every,
        "canvas": bool(args.canvas), "dataset": args.dataset,
        "tflite": args.tflite})

    if args.source == "stdin":
        state = run_monitor(iter(sys.stdin.readline, ""),
                            args.render_every, draw_canvas=args.canvas,
                            save_png=args.save_png)
    elif args.source == "socket":
        state = run_monitor(
            socket_stream(args.host, args.port, listen=args.listen),
            args.render_every, draw_canvas=args.canvas,
            save_png=args.save_png)
    elif args.source == "file":
        with open(args.file) as f:
            state = run_monitor([f.read()], args.render_every,
                                draw_canvas=args.canvas,
                                save_png=args.save_png)
    else:
        from yoloface_tpu_torch.host.streamer import (CameraStreamer,
                                                      directory_frames,
                                                      synthetic_frames)
        from yoloface_tpu_torch.pipeline.e2e import load_pipeline
        pipe = load_pipeline(args.tflite, mode="arena_exact",
                             device=args.device)
        src = (synthetic_frames(args.batch_size)
               if args.source == "synthetic"
               else directory_frames(args.dataset, args.batch_size))
        state = MonitorState()
        parser = protocol.StreamParser()
        if args.save_png:
            os.makedirs(args.save_png, exist_ok=True)

        def on_frame(text):
            for frame in parser.feed(text):
                state.update(frame)
                _render_point(state, args.render_every, sys.stdout,
                              args.canvas, args.save_png)

        stats = CameraStreamer(pipe, src).run(args.batches,
                                              on_frame=on_frame)
        print("streamer:", json.dumps(stats))
    print("summary:", json.dumps(state.summary()))


if __name__ == "__main__":
    main()
