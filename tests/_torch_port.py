"""Shared pieces of the PyTorch port's tests (``tests/test_torch_*.py``)."""
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip on a host without one
    (decided here, when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
