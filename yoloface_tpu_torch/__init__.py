"""yoloface_tpu_torch: the PyTorch and CUDA port of yoloface_tpu for one H100.

The camera-frame detection path (RGB565 frames -> int8 yoloface net ->
detections) in the exact, fast and fast2 bits, with hand-written CUDA
kernels under ``csrc/``: the preprocess, the activation-arena stage (all
three bit semantics), the fused YOLO head and the top-K selection.  Subpackages keep the
names of their ``yoloface_tpu`` counterparts.  Nothing here imports jax or
``yoloface_tpu``; the CPU tests hold each module against its JAX twin.

Serving entry point: ``yoloface_tpu_torch.pipeline.e2e.load_pipeline``.
"""
