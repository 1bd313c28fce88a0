"""The port's top-k and top-p masks (``serve/sampling.py``) vs the JAX
package's, on seeded logits with ties: the masked logits must be
identical."""
import jax
import numpy as np
import pytest
import torch

from repro.serve.sampling import mask_top_k as ref_top_k
from repro.serve.sampling import mask_top_p as ref_top_p
from repro_torch.serve.sampling import mask_top_k, mask_top_p


@pytest.mark.parametrize("k", [0, 1, 5, 300])
@pytest.mark.parametrize("p", [0.0, 0.5, 0.9, 1.0])
def test_top_k_top_p_masks_match_reference(k, p):
    rng = np.random.default_rng(k * 7 + int(p * 10))
    logits = (rng.standard_normal(257) * 3).astype(np.float32)
    logits[rng.integers(0, 257, 20)] = logits[0]       # ties
    want_k = np.asarray(ref_top_k(jax.numpy.asarray(logits), k))
    want_p = np.asarray(ref_top_p(jax.numpy.asarray(logits),
                                  np.float32(p)))
    np.testing.assert_array_equal(
        mask_top_k(torch.from_numpy(logits), k).numpy(), want_k)
    np.testing.assert_array_equal(
        mask_top_p(torch.from_numpy(logits), np.float32(p)).numpy(), want_p)
