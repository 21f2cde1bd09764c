"""The host side of the port: the UART text protocol, the native frame
pipeline (``native/framepipe.cpp`` through ``ctypes``), the camera
streamers that feed the card, the terminal monitor and its Tkinter GUI.
The counterparts of ``yoloface_tpu.host``; nothing here imports jax."""
