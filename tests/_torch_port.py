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


@pytest.fixture(autouse=True)
def amp_uninit():
    """Leave no O1 / O4 casts of the port behind a test (import it into a
    test module to make it autouse there)."""
    yield
    from apex_tpu_torch.amp import amp as _amp
    if _amp.is_initialized():
        _amp.uninit()
