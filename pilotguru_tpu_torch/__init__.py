"""pilotguru_tpu_torch: the PyTorch + CUDA port of pilotguru_tpu.

The JAX package ``pilotguru_tpu`` is the reference; this package mirrors its
module names (``vo/features.py`` <-> ``pilotguru_tpu/vo/features.py``, ...).
It imports ``torch`` and never ``jax``, and no module of the reference
either: the host formats and video readers it needs are its own copies
(``formats/``, ``video/``). The kernels that the reference wrote in Pallas for
the TPU are hand-written CUDA kernels for Hopper under ``csrc/``, built by
``cuda_lib``.

Precision policy: float32 products on the card stay full float32. TF32 in
the geometry matmuls is the hazard that collapsed tracking on the TPU's
bf16 default, and a TF32 blur flips BRIEF bits (descriptors quantize
round(patch * 255)); so TF32 is off for cuBLAS and cuDNN alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
