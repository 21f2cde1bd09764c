"""Interactive Tkinter monitor dashboard — the live GUI twin.

Reproduces the reference host GUI's surfaces (the reference project's
`上位机/IAP/main.py`: FaceDetectionMonitor) on top of the framework's
transport/state stack:

  * connection config panel with source selector + connect/disconnect
    (the serial-port picker + baud combo, main.py:59-118 / 228-311 —
    pyserial is absent here, so the byte-stream source is the TCP
    ``socket_stream`` / a protocol file / stdin),
  * live statistics labels (current/total faces, frame counter,
    main.py:425-446),
  * rolling face-count history chart (the matplotlib panel,
    main.py:448-472 — drawn on a tk.Canvas polyline; same 50-frame
    window as ``MonitorState.history``),
  * detection box canvas on the 112x112 display space (the "模拟显示"
    canvas, main.py:474-552), with per-face id/confidence labels,
  * JSON config persistence across runs (main.py:585-613).

The counterpart of ``yoloface_tpu.host.gui``, on the port's monitor.
All data handling is ``MonitorState`` + ``protocol.StreamParser`` (the
tested headless core); this module is a thin widget layer, and every
coordinate/geometry computation it adds lives in pure functions
(``chart_points``, ``box_px``) so the suite can pin them without a
display.  ``python -m yoloface_tpu_torch.host.monitor --gui`` launches it and
falls back to the headless loop when Tk has no display.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import List, Sequence, Tuple

from yoloface_tpu_torch.host import protocol
from yoloface_tpu_torch.host.monitor import (MonitorState, load_config,
                                             save_config, socket_stream)

DISPLAY = 112          # firmware display space (112x112, main.py:47-49)


# --------------------------------------------------------------------------
# pure geometry (unit-tested headlessly)
# --------------------------------------------------------------------------
def chart_points(history: Sequence[int], w: int, h: int,
                 pad: int = 8) -> List[Tuple[float, float]]:
    """History values -> polyline pixel points for a w x h canvas.
    y is flipped (tk origin is top-left), scaled to the running max so
    the chart stays in frame like the GUI's autoscaled axes."""
    vals = list(history)
    if not vals:
        return []
    hi = max(max(vals), 1)
    n = len(vals)
    xs = [pad + (w - 2 * pad) * (i / max(n - 1, 1)) for i in range(n)]
    ys = [h - pad - (h - 2 * pad) * (v / hi) for v in vals]
    return list(zip(xs, ys))


def box_px(face: protocol.Face, canvas: int) -> Tuple[int, int, int, int]:
    """Display-space face box -> canvas pixels (square canvas)."""
    s = canvas / DISPLAY
    return (round(face.x1 * s), round(face.y1 * s),
            round(face.x2 * s), round(face.y2 * s))


# --------------------------------------------------------------------------
# the widget layer
# --------------------------------------------------------------------------
class MonitorGUI:
    """Live dashboard window.  A reader thread feeds protocol text into
    a queue; the Tk ``after`` loop drains it, updates ``MonitorState``
    and redraws — the thread/queue split of the reference GUI
    (receive_data thread + data_queue + update_display, main.py:
    278-311, 415-423)."""

    POLL_MS = 100
    CANVAS = 336       # 3x the 112 display space
    CHART_W, CHART_H = 420, 220

    def __init__(self, root, config_path: str = "monitor_config.json"):
        import tkinter as tk
        from tkinter import ttk

        self.tk, self.ttk = tk, ttk
        self.root = root
        root.title("yoloface detection monitor")
        self.state = MonitorState()
        self.parser = protocol.StreamParser()
        self.queue: "queue.Queue[str]" = queue.Queue()
        self.reader: threading.Thread | None = None
        self.stop_flag = threading.Event()
        self.config_path = config_path
        cfg = load_config(config_path)

        main = ttk.Frame(root, padding=8)
        main.grid(row=0, column=0, sticky="nsew")
        root.columnconfigure(0, weight=1)
        root.rowconfigure(0, weight=1)

        # --- connection panel (serial-config analogue, main.py:59-118)
        conn = ttk.LabelFrame(main, text="source", padding=8)
        conn.grid(row=0, column=0, columnspan=2, sticky="ew", pady=(0, 8))
        ttk.Label(conn, text="type:").grid(row=0, column=0)
        self.source_var = tk.StringVar(value=cfg.get("gui_source", "socket"))
        ttk.Combobox(conn, textvariable=self.source_var, width=8,
                     values=("socket", "file")).grid(row=0, column=1,
                                                     padx=(4, 16))
        ttk.Label(conn, text="host:").grid(row=0, column=2)
        self.host_var = tk.StringVar(value=cfg.get("gui_host", "127.0.0.1"))
        ttk.Entry(conn, textvariable=self.host_var,
                  width=12).grid(row=0, column=3, padx=(4, 16))
        ttk.Label(conn, text="port:").grid(row=0, column=4)
        self.port_var = tk.StringVar(value=str(cfg.get("gui_port", 8765)))
        ttk.Entry(conn, textvariable=self.port_var,
                  width=6).grid(row=0, column=5, padx=(4, 16))
        ttk.Label(conn, text="file:").grid(row=0, column=6)
        self.file_var = tk.StringVar(value=cfg.get("gui_file", ""))
        ttk.Entry(conn, textvariable=self.file_var,
                  width=18).grid(row=0, column=7, padx=(4, 16))
        self.connect_btn = ttk.Button(conn, text="connect",
                                      command=self.connect)
        self.connect_btn.grid(row=0, column=8, padx=4)
        self.disconnect_btn = ttk.Button(conn, text="disconnect",
                                         command=self.disconnect,
                                         state="disabled")
        self.disconnect_btn.grid(row=0, column=9, padx=4)
        self.status_var = tk.StringVar(value="disconnected")
        ttk.Label(conn, textvariable=self.status_var).grid(row=0, column=10,
                                                           padx=8)

        # --- stats labels (main.py:425-446)
        stats = ttk.LabelFrame(main, text="statistics", padding=8)
        stats.grid(row=1, column=0, sticky="nsew", pady=(0, 8))
        self.stats_var = tk.StringVar(value="waiting for frames…")
        ttk.Label(stats, textvariable=self.stats_var,
                  font=("TkFixedFont",)).grid(row=0, column=0, sticky="w")
        self.table_var = tk.StringVar(value="")
        ttk.Label(stats, textvariable=self.table_var,
                  font=("TkFixedFont",)).grid(row=1, column=0, sticky="w")

        # --- history chart (main.py:448-472)
        chart_f = ttk.LabelFrame(main, text="face-count history", padding=4)
        chart_f.grid(row=1, column=1, rowspan=2, sticky="nsew")
        self.chart = tk.Canvas(chart_f, width=self.CHART_W,
                               height=self.CHART_H, bg="#ffffff")
        self.chart.grid(row=0, column=0)

        # --- detection canvas (main.py:474-552)
        canvas_f = ttk.LabelFrame(main, text="detections (112x112 space)",
                                  padding=4)
        canvas_f.grid(row=2, column=0, sticky="nsew")
        self.canvas = tk.Canvas(canvas_f, width=self.CANVAS,
                                height=self.CANVAS, bg="#202020")
        self.canvas.grid(row=0, column=0)

        root.protocol("WM_DELETE_WINDOW", self.close)
        root.after(self.POLL_MS, self._poll)

    # ------------------------------------------------------------ transport
    def connect(self):
        if self.reader is not None:
            return
        self.stop_flag.clear()
        src = self.source_var.get()
        if src == "file":
            path = self.file_var.get()

            def read():
                try:
                    with open(path) as f:
                        self.queue.put(f.read())
                    self.queue.put("")        # EOF marker
                except OSError as e:
                    self.queue.put(f"\x00error: {e}")
        else:
            host, port = self.host_var.get(), int(self.port_var.get())

            def read():
                try:
                    for chunk in socket_stream(host, port, timeout=5.0):
                        if self.stop_flag.is_set():
                            return
                        self.queue.put(chunk)
                    self.queue.put("")
                except OSError as e:
                    self.queue.put(f"\x00error: {e}")

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        self.status_var.set("connected")
        self.connect_btn.config(state="disabled")
        self.disconnect_btn.config(state="normal")
        save_config(self.config_path, {
            **load_config(self.config_path),
            "gui_source": src, "gui_host": self.host_var.get(),
            "gui_port": int(self.port_var.get()),
            "gui_file": self.file_var.get()})

    def disconnect(self):
        self.stop_flag.set()
        self.reader = None
        self.status_var.set("disconnected")
        self.connect_btn.config(state="normal")
        self.disconnect_btn.config(state="disabled")

    def close(self):
        self.disconnect()
        self.root.destroy()

    # -------------------------------------------------------------- render
    def _poll(self):
        updated = False
        while True:
            try:
                chunk = self.queue.get_nowait()
            except queue.Empty:
                break
            if chunk.startswith("\x00error"):
                self.status_var.set(chunk[1:])
                self.disconnect()
                continue
            if chunk == "":
                self.disconnect()
                self.status_var.set("stream ended")
                continue
            for frame in self.parser.feed(chunk):
                self.state.update(frame)
                updated = True
        if updated:
            self.redraw()
        self.root.after(self.POLL_MS, self._poll)

    def redraw(self):
        st = self.state
        f = st.last_frame
        self.stats_var.set(
            f"frame {f.number}: {f.total} face(s)   "
            f"session: {st.frames} frames, {st.total_faces} faces total"
            if f else "waiting for frames…")
        self.table_var.set(st.face_table())

        self.canvas.delete("all")
        if f:
            for face in f.faces:
                x1, y1, x2, y2 = box_px(face, self.CANVAS)
                self.canvas.create_rectangle(x1, y1, x2, y2,
                                             outline="#00ff66", width=2)
                self.canvas.create_text(
                    x1 + 2, max(y1 - 8, 6), anchor="w", fill="#00ff66",
                    text=f"#{face.id} {face.confidence:.2f}",
                    font=("TkFixedFont", 8))

        self.chart.delete("all")
        pts = chart_points(st.history, self.CHART_W, self.CHART_H)
        if len(pts) >= 2:
            self.chart.create_line(*[c for p in pts for c in p],
                                   fill="#2060c0", width=2)
        for x, y in pts:
            self.chart.create_oval(x - 2, y - 2, x + 2, y + 2,
                                   fill="#2060c0", outline="")
        hi = max(max(st.history), 1) if st.history else 1
        self.chart.create_text(6, 6, anchor="nw", fill="#606060",
                               text=f"max {hi}")


def run_gui(config_path: str = "monitor_config.json") -> bool:
    """Launch the dashboard; returns False when Tk cannot open a display
    (headless host) so the caller can fall back to the terminal loop."""
    try:
        import tkinter as tk
        root = tk.Tk()
    except Exception as e:  # TclError: no $DISPLAY — headless machine
        print(f"monitor --gui: no display available ({e}); "
              "falling back to the headless loop", flush=True)
        return False
    MonitorGUI(root, config_path)
    root.mainloop()
    return True
