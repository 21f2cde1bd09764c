"""The plain reference: the benchmark's own tflite reader, int8 ops and
head, in plain torch.  It imports nothing of the program."""
