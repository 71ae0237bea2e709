"""Shared helpers of the PyTorch-port parity tests: numpy is the bridge
between the JAX reference and the port."""
import numpy as np
import pytest
import torch


def np_tree(params, dtype=np.float64):
    """flax param tree -> nested dict of numpy arrays in ``dtype``."""
    if hasattr(params, "items"):
        return {k: np_tree(v, dtype) for k, v in params.items()}
    return np.asarray(params, dtype)


def tt(x, dtype=torch.float64):
    """numpy -> CPU tensor."""
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def one_thread():
    """torch on one intra-op thread for a module: its tensors are tiny, and
    several test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
