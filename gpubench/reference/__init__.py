"""Plain references the benchmark holds the program to. They import
nothing of the program under test, of JAX or of the JAX package."""

import contextlib


@contextlib.contextmanager
def plain_float32():
    """Float32 products without TF32 (cuBLAS and cuDNN) within; the caller's
    settings after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
