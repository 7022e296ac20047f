"""Input and output dropout at bfloat16 compute (the ``quickdraw345_dp``
settings: bfloat16 compute and residuals) against the JAX package, on
the CPU: ``loss(train=True)`` and its gradients with input, output and
both dropouts, for the ``lstm``, ``layer_norm`` and ``hyper`` decoders,
fused and plain; metrics within ``rtol=1e-4, atol=1e-6``, gradients
within ``rtol=1e-3, atol=1e-4`` (``tests/test_torch_train.py``'s bfloat16
tolerances). The float32 cases and the rest are
``tests/test_torch_dropout.py``'s.
"""

import pytest
import torch

from tests._torch_dropout_common import (CELLS, DROPOUTS,
                                         check_loss_and_gradients)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dropout", list(DROPOUTS))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fused", [True, False])
def test_bf16_loss_and_gradients_match_jax(dropout, cell, fused):
    check_loss_and_gradients(dropout, cell, fused, "bfloat16")
