"""Times of the isolated-word E-step kernels at full covariance D = 39
(needs a CUDA card; not a tier-1 test):

    PYTHONPATH=TREE python tests/torch_em_wide_compare.py time [INPUTS.pt]

The batch and LBG start model of chip_smoke.py's em_full39 cell (S = 6,
M = 4, full covariance at D = 39, B = 2048 utterances of 103-213 frames,
seeded), built by chip_smoke.py's own functions as its train phase builds
them (make_dataset, the .perfil files, load_batch, create_initial_model);
with INPUTS.pt they are saved there by the first run and loaded by the
next ones, so that every tree times the same inputs.  The package comes
from PYTHONPATH (this checkout's, or another one unpacked with git
archive).  For emit_forward (#2) and backward_stats (#3): CUDA-event
medians of 20 after 3 warm-ups, and each wrapper's kernels' device time
(chip_smoke.em_device_ms: the recursion kernel, and past full D = 16 the
z-GEMM emission or moments beside it, by kernel); one em_full39 EM
iteration through the kernels (em_step: its default route); both again
with the per-mixture q stored by #2 and read by #3's moments
(*_stored_q); the moments' device time at ranges aimed at 2, 4, 8 and 16
blocks an SM; the z-GEMM of the emission as one
torch.matmul (fp32, TF32 off: G (S M D, D) times every column's x - origin,
a ceiling of its multiply-adds, not a port); the write of a (T, S M, B)
float32 buffer, the per-mixture q that #2 would add for #3 to read instead
of recomputing it; the blocks an SM (fused_em.occupancy); the moments'
candidate columns and those each row group keeps (kept_columns).  One
JSON line with the card's name and power limit.  Run two trees in one
call, in the order parent, change, change, parent, to compare them.
"""

import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# chip_smoke.py of this checkout (the other tree's may predate its helpers); the package comes from PYTHONPATH
_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = cs
_spec.loader.exec_module(cs)


def em_full39_inputs(cache: str | None):
    """em_full39's LBG start model and batch on the card, from cache when
    it holds them (else built, and saved there when cache is given)."""
    from srhmm_tpu_torch.io.dataset import UtteranceBatch

    if cache and Path(cache).is_file():
        d = torch.load(cache, weights_only=False)
    else:
        from srhmm_tpu_torch.init.lbg import create_initial_model
        from srhmm_tpu_torch.io import load_batch

        S, M, D, t_range, B = cs.EM_FULL39
        with tempfile.TemporaryDirectory() as tmp:
            name = f"em_full39_S{S}_M{M}_D{D}"
            lst = cs.write_utterances(Path(tmp), name, cs.make_dataset(22, B, S, M, D, t_range, full=True))
            host = load_batch(lst, relative_to=tmp, dtype=torch.float64)
        utts = [host.features[i, : int(host.lengths[i])].numpy() for i in range(B)]
        init = create_initial_model([utts], S, [M], word=name, cov_type="full")
        d = {"model": init.astype(torch.float32), "features": host.features.to(torch.float32),
             "lengths": host.lengths}
        if cache:
            Path(cache).parent.mkdir(parents=True, exist_ok=True)
            torch.save(d, cache)
    return d["model"].to("cuda"), UtteranceBatch(d["features"].to("cuda"), d["lengths"].to("cuda"))


def kept_columns(model, batch, lb, la, valid) -> dict:
    """The moments' candidate columns (t, b) and, per row group of
    fused_em.moment_groups, those with a gamma that is not exactly 0.0f at
    one of the group's states (a diagnostic of the moments' work): gamma =
    exp(min(la + beta - z, 0)) at t < length of a valid utterance, beta from
    the backward lattice kernel."""
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    T, S, B = la.shape
    M = model.mixture_numbers[0]
    beta = kl.backward_lattice(lb, model.log_trans().to(torch.float32), batch.lengths)
    log_z = torch.where(valid, la[-1, -1], 0.0)
    on = (torch.arange(T, device=la.device)[:, None] < batch.lengths[None, :]) & valid[None, :]
    nz = (torch.exp(torch.clamp(la + beta - log_z, max=0.0)) != 0.0) & on[:, None, :]
    per = max(1, 8 // M)
    groups = [int(nz[:, s0:s0 + per].any(1).sum()) for s0 in range(0, S, per)]
    return {"candidates": T * B, "valid_columns": int(on.sum()), "kept_by_group": groups,
            "nonzero_state_columns": int(nz.sum())}


def time_kernels(cache: str | None) -> dict:
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels.common import NEG_INF, trans_band
    from srhmm_tpu_torch.train.em import em_step

    model, batch = em_full39_inputs(cache)
    band = trans_band(model.trans.cpu().numpy())
    feats_tdb = batch.features.permute(1, 2, 0).contiguous()
    T, D, B = feats_tdb.shape
    origin = model.streams[0].means.mean(dim=(0, 1))
    packed = (fe.pack_lane_constants(model.streams[0], torch.float32, origin=origin),)
    k1 = ((feats_tdb,), packed, (origin,), model.trans, batch.lengths, band)
    lb, la = fe.emit_forward(*k1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (batch.lengths > 0)
    k2 = ((feats_tdb,), lb, la, packed, (origin,), model.trans, batch.lengths, torch.where(valid, log_z, 0.0),
          valid.to(torch.float32), band)
    wide = hasattr(fe, "wide_full") and fe.wide_full([D], True)  # a tree before the z-GEMM blocks has none
    out = {"T": T, "D": D, "B": B, "band": band, "wide": wide,
           "columns": kept_columns(model, batch, lb, la, valid)}
    calls = {"emit_forward": lambda: fe.emit_forward(*k1), "backward_stats": lambda: fe.backward_stats(*k2)}
    q = (fe.stored_q_buffers((feats_tdb,), model.mixture_numbers, model.trans.shape[-1], True)
         if hasattr(fe, "stored_q_buffers") else None)
    if q is not None:  # the stored per-mixture q: emit-forward writes it, the moments read it
        fe.emit_forward(*k1, q_out=q)
        calls["emit_forward_stored_q"] = lambda: fe.emit_forward(*k1, q_out=q)
        calls["backward_stats_stored_q"] = lambda: fe.backward_stats(*k2, q=q)
    for name, fn in calls.items():
        kind = name.removesuffix("_stored_q")
        dev, parts = cs.em_device_ms(torch, fn, kind, wide)
        out[name] = {"ms": cs.median_ms(torch, fn), "device_ms": dev, "device_ms_parts": parts,
                     "occupancy": fe.occupancy(0 if kind == "emit_forward" else 1, *k1)}
    out["em_iteration_ms"] = cs.median_ms(torch, lambda: em_step(model, batch, fused=True, feats_tdb=feats_tdb,
                                                                 band=band))
    if hasattr(fe, "WIDE_MOMENT_BLOCKS"):  # the moments' device time against the blocks an SM its ranges aim at
        aim = fe.WIDE_MOMENT_BLOCKS
        out["moments_by_blocks_an_sm"] = {}
        for n in (2, 4, 8, 16):
            fe.WIDE_MOMENT_BLOCKS = n
            out["moments_by_blocks_an_sm"][n] = cs.kernel_device_ms(torch, calls["backward_stats"],
                                                                    "em_moments_wide_kernel")[0]
        fe.WIDE_MOMENT_BLOCKS = aim
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        G = packed[0][0]  # (S M D, D): row d M S + m S + s holds row d of L^T for (s, m)
        x = (feats_tdb - origin[None, :, None]).permute(1, 0, 2).reshape(D, T * B)
        z = torch.empty((G.shape[0], T * B), dtype=torch.float32, device="cuda")
        out["zgemm_matmul"] = {"ms": cs.median_ms(torch, lambda: torch.matmul(G, x, out=z)),
                               "flops": 2 * G.shape[0] * D * T * B, "bytes_written": 4 * z.numel()}
        del z
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    S, M = model.trans.shape[-1], model.mixture_numbers[0]
    q = torch.empty((T, S * M, B), dtype=torch.float32, device="cuda")
    out["stored_q"] = {"bytes": 4 * q.numel(), "write_ms": cs.median_ms(torch, lambda: q.fill_(0.0))}
    return out


def main(argv) -> int:
    if argv[:1] != ["time"]:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    import srhmm_tpu_torch

    print(json.dumps({"tree": str(Path(srhmm_tpu_torch.__file__).resolve().parents[1]), "card": smi,
                      **time_kernels(argv[1] if len(argv) > 1 else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
