"""Feature normalization for training (counterpart of
``srhmm_tpu/features/frontend.py``).

Only ``global_cmvn_stats`` is ported: the train CLI's ``--cmvn global``
needs it.  The MFCC / filterbank frontend is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def global_cmvn_stats(feats, lengths=None, eps: float = 1.0e-8):
    """Corpus-level mean/std over the valid frames of a padded (B, T, D)
    batch (tensor or array).  Returns ((D,) mean, (D,) std) as float64
    numpy arrays.

    This is the fast trainer's precision lever: EM is exactly equivariant
    under the affine map y = (x - mean)/std (densities pick up a constant
    Jacobian, occupancies are unchanged), so training in normalized space
    and de-normalizing the result (models.gmm_hmm.denormalize_model)
    reproduces raw-space training, while the float32 moment statistics
    round relative to O(1) magnitudes instead of the raw feature scale."""
    f = _host64(feats)
    if f.ndim == 2:
        f = f[None]
    if lengths is None:
        valid = np.ones(f.shape[:2], bool)
    else:
        ln = _host64(lengths).reshape(-1)
        valid = np.arange(f.shape[1])[None, :] < ln[:, None]
    sel = f[valid]  # (n_frames, D)
    mean = sel.mean(0)
    std = np.sqrt(np.maximum(sel.var(0), eps))
    return mean, std
