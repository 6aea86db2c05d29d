"""lstm_ctc_ocr_torch — the CRNN + CTC OCR framework in PyTorch for NVIDIA Hopper.

A port of ``lstm_ctc_ocr_tpu`` (JAX/Pallas on a TPU), module for module under
the same names. It imports ``torch`` and never ``jax``, and keeps its own
copies of everything it needs; the JAX package is the reference its tests
hold it against.

Entry points run on CUDA by default and raise when CUDA is missing, unless
the caller passes ``device='cpu'``. Every kernel the JAX package wrote in
Pallas becomes a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use (``ops/_build.py``); on a CPU tensor each kernel's wrapper runs its
plain PyTorch version instead.
"""
