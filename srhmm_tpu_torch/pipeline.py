"""The end-to-end training pipeline (counterpart of ``srhmm_tpu/pipeline.py``).

Only ``_bucketed_embedded_stats`` is ported so far: the tied-training CLI
(cli/train_embedded.py --tied) reads its per-(unit, state) statistics.  The
rest of the pipeline (features, monophone -> tree -> tied chain, decode and
WER) comes with the frontend slice.
"""

from __future__ import annotations

import numpy as np
import torch


def _bucketed_embedded_stats(models, utts, transcripts, pad_multiple: int = 32):
    """Summed embedded E-step SuffStats over shape buckets (the
    train_embedded packing, one plain batch_stats pass per bucket, float32
    features on the models' device): the per-(unit, state) occupancy and
    moment source of tree clustering."""
    from .train.embedded import _add_stats, batch_stats, pack_buckets

    agg = None
    utts = [np.asarray(u, np.float32) for u in utts]
    for trs, feats, lengths in pack_buckets(utts, transcripts, torch.float32, models.trans.device,
                                            pad_multiple):
        st = batch_stats(models, trs, feats, lengths)
        agg = st if agg is None else _add_stats(agg, st)
    return agg
