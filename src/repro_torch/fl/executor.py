"""Execution layer of the Track-A round engine — the port of
``repro.fl.executor``'s plan-shaped (ragged), unsharded path, for every
scheme.

The host groups the round's participants by quantized (b, τ) tier
(`TierGroup`); `RoundExecutor.step_ragged` walks the tiers in order and,
for each **tier chunk** (≤ ``chunk`` participants, padded to a rung of the
chunk ladder), runs the per-participant round batched over the chunk:

1. download threshold: an O(1) lookup per participant in the cdf of ONE
   histogram of the global model per round (`_hist`);
2. hybrid compress of the shared global vector at each participant's
   threshold — one kernel launch for the chunk;
3. Caesar: Fig.-3 recover against each participant's stale pool row — one
   launch; every other scheme: plain stale substitution on the compressed
   slots (``torch.where``, as the reference leaves it to XLA);
4. τ masked SGD steps on the chunk's stacked models (grouped conv + bmm,
   one backward of the summed per-participant losses);
5. upload threshold (one histogram per participant, one launch), then
   top-k sparsify of the upload delta — or, for ProWD (``quantize``), a
   second hybrid compress, of the deltas row by row (x per row, one
   launch), dequantized to sign·mean on the compressed slots.

So a chunk step launches one histogram and one compress kernel for every
scheme, plus one recover for Caesar and one more compress for ProWD; each
round adds the global model's histogram.

The uploads fold into the round's sum in fixed order (`weighted_row_fold`),
the participants' new rows are written back into the pool in place
(``index_copy_`` over the valid rows only), and `_finalize` applies the
mean. Padded rows of a chunk gather a clamped (valid) pool row, train with
zero masks and are never scattered or folded with non-zero weight.

Masked (uniform-cap) execution, error feedback, bf16 pools and sharding
are not ported yet (the simulator raises for them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import batchsize as BS
from repro_torch.core import compression as C
from repro_torch.fl.robust import weighted_row_fold


@dataclasses.dataclass
class TierGroup:
    """One occupied (b, τ) execution tier of a round. ``pos`` are positions
    into the round's ``parts`` array; the batch arrays hold ``g_pad`` rows
    (zero-filled padding beyond ``len(pos)``)."""
    b: int
    tau: int
    pos: np.ndarray           # [g] positions into parts
    g_pad: int
    slices: list              # [(start, chunk_rung)] from tier_layout
    xs: np.ndarray            # [g_pad, tau, b, ...feat]
    ys: np.ndarray            # [g_pad, tau, b]
    ws: np.ndarray            # [g_pad, tau, b] sample weights
    ims: np.ndarray           # [g_pad, tau] iteration masks


class RoundExecutor:
    """The flat-parameter round step over a ClientStateStore pool, batched
    over tier chunks. ``apply_fn(params, x)`` maps {name: [c, *shape]}
    parameter views and [c, B, ...] inputs to [c, B, n_classes] logits."""

    def __init__(self, cfg, apply_fn, spec: C.FlatSpec, n_part: int,
                 device, quantize: bool = False):
        self.cfg = cfg
        self.apply_fn = apply_fn
        self.spec = spec
        self.device = torch.device(device)
        # scheme switches, fixed for the simulation: Fig.-3 recovery of the
        # download (Caesar only) and ProWD's quantized upload
        self.use_recovery = cfg.scheme == "caesar"
        self.quantize = bool(quantize)
        chunk_size = cfg.chunk_size
        if chunk_size is None:
            chunk_size = C.auto_chunk(spec.n_params, n_part)
        self.chunk = C.chunk_layout(n_part, chunk_size)[0]
        self.b_cap, self.tau_cap = cfg.caesar.b_max, cfg.caesar.tau
        self.b_min = cfg.caesar.b_min
        # telemetry: cumulative per-tier participant counts, the distinct
        # tier-chunk shapes run, plan-shaped vs cap work, and the number of
        # tier-chunk steps and rounds (`kernel_launches` turns them into the
        # launches of each kernel)
        self.tier_occupancy: dict = {}
        self._shapes_seen: set = set()
        self.work_ragged = 0
        self.work_cap = 0
        self.chunk_calls = 0
        self.rounds = 0

    # -- tier shape lattice -------------------------------------------------

    def chunk_rungs(self) -> list:
        """The chunk-size ladder: {chunk} ∪ {powers of two < chunk}."""
        rungs = {self.chunk}
        r = 1
        while r < self.chunk:
            rungs.add(r)
            r <<= 1
        return sorted(rungs)

    def tier_layout(self, g: int) -> tuple[int, list]:
        """Chunk-rung decomposition of a tier group of ``g`` participants:
        ⌊g/chunk⌋ full chunks plus a power-of-two tail rung covering the
        remainder. Returns (g_pad, [(start, rung)])."""
        if g <= 0:
            raise ValueError(f"tier group must be non-empty, got {g}")
        k, r = divmod(g, self.chunk)
        slices = [(i * self.chunk, self.chunk) for i in range(k)]
        g_pad = k * self.chunk
        if r:
            rung = min(1 << (r - 1).bit_length(), self.chunk)
            slices.append((g_pad, rung))
            g_pad += rung
        return g_pad, slices

    def shape_lattice_bound(self) -> int:
        """Upper bound on distinct tier-chunk shapes: the (b, τ) tier
        lattice × the chunk-rung ladder."""
        return (BS.tier_lattice_size(self.b_min, self.b_cap, self.tau_cap)
                * len(self.chunk_rungs()))

    def kernel_launches(self) -> dict:
        """The compression-kernel launches the chunk steps and rounds run so
        far imply: per chunk step one histogram and one compress, one more
        compress with ``quantize`` and one recover with recovery; per round
        one more histogram."""
        calls = self.chunk_calls
        return {"magnitude_histogram": self.rounds + calls,
                "hybrid_compress": calls * (2 if self.quantize else 1),
                "recover": calls if self.use_recovery else 0}

    def telemetry(self) -> dict:
        occ = {f"b{b}xt{t}": int(n)
               for (b, t), n in sorted(self.tier_occupancy.items())}
        return {"tier_occupancy": occ,
                "compiled_tier_shapes": len(self._shapes_seen),
                "shape_lattice_bound": self.shape_lattice_bound(),
                "work_fraction": (self.work_ragged / self.work_cap
                                  if self.work_cap else 1.0),
                "chunk_calls": self.chunk_calls,
                "rounds": self.rounds,
                "kernel_launches": self.kernel_launches()}

    # -- the per-participant round, batched over a chunk --------------------

    @staticmethod
    def _ce_loss(logits, y, w):
        """[c] weighted mean cross-entropy per participant (the reference's
        ce_loss row by row)."""
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, y[..., None])[..., 0]
        return -torch.sum(ll * w, dim=-1) / torch.clamp(
            torch.sum(w, dim=-1), min=1.0)

    def _local_train(self, w, xs, ys, ws, ims, lr):
        """τ masked SGD steps for every row: p ← p − (lr·m)·∇ℓ(p)."""
        p = w
        for k in range(xs.shape[1]):
            with torch.enable_grad():
                q = p.detach().requires_grad_(True)
                logits = self.apply_fn(C.unflatten_vector(q, self.spec),
                                       xs[:, k])
                loss = self._ce_loss(logits, ys[:, k], ws[:, k]).sum()
                (g,) = torch.autograd.grad(loss, q)
            p = p - (lr * ims[:, k])[:, None] * g
        return p

    def participant_round(self, global_f, g_cdf, g_max, local, xs, ys, ws,
                          ims, lr, theta_d, theta_u):
        """One round for each row of a chunk, on flat [c, n_params] rows.
        Returns (uploads, new rows, down bits, up bits, upload-delta norms)."""
        n_params = self.spec.n_params
        # download: per-participant threshold from the shared global cdf
        thr_d = C.threshold_from_cdf(g_cdf, g_max, theta_d)
        kept, sign, cnt, ssum, smax = C.fused_compress(global_f, thr_d)
        mean_abs = ssum / torch.clamp(cnt, min=1).to(torch.float32)
        # sign == 0 marks a full-precision slot, so an exact-zero compressed
        # weight arrives as its true value 0 (the reference's convention)
        if self.use_recovery:
            w_init = C.fused_recover(kept, sign, local, mean_abs, smax)
        else:   # plain stale substitution on the compressed slots
            w_init = torch.where(sign != 0, local, kept)
        down_bits = C.hybrid_payload_bits(n_params, cnt)
        w_fin = self._local_train(w_init, xs, ys, ws, ims, lr)
        delta = w_init - w_fin
        gnorm = torch.linalg.vector_norm(delta, dim=-1)
        thr_u = C.fused_threshold(delta, theta_u)
        if self.quantize:   # ProWD: 1-bit compressed slots at sign·mean
            k2, s2, c2, ss2, _ = C.fused_compress(delta, thr_u)
            mean2 = ss2 / torch.clamp(c2, min=1).to(torch.float32)
            up = torch.where(s2 != 0, s2.to(torch.float32) * mean2[:, None],
                             k2)
            up_bits = C.hybrid_payload_bits(n_params, c2)
        else:               # top-k sparsification
            up, up_bits = C.topk_sparsify_at(delta, thr_u)
        return up, w_fin, down_bits, up_bits, gnorm

    def _tier_chunk_defer(self, store, global_f, g_cdf, g_max, slots, n_valid,
                          xs, ys, ws, ims, lr, theta_d, theta_u):
        """Gather the chunk's rows, run the round, write the valid rows back
        in place. Returns the raw uploads [c, n_params] for the fold."""
        pool = store.pool
        idx = torch.from_numpy(np.minimum(slots, store.capacity - 1)
                               .astype(np.int64)).to(self.device)
        local = pool.index_select(0, idx)
        ups, new_rows, db, ub, gn = self.participant_round(
            global_f, g_cdf, g_max, local, xs, ys, ws, ims, lr, theta_d,
            theta_u)
        pool.index_copy_(0, idx[:n_valid], new_rows[:n_valid])
        return ups, db, ub, gn

    def _hist(self, global_f):
        """(cdf [1, N_BINS], max_abs [1]) of the global model — once per
        round, shared by every participant's download threshold."""
        return C.fused_histogram_cdf(global_f)

    def _finalize(self, global_f, up_sum, cnt: int):
        """Algorithm 1 line 13: the mean of the round's uploads."""
        denom = torch.full((), float(max(cnt, 1)), dtype=torch.float32,
                           device=global_f.device)
        return global_f - up_sum / denom

    # -- host-side marshalling ----------------------------------------------

    def _tier_chunks(self, tg: TierGroup, slots32: np.ndarray,
                     theta_d: np.ndarray, theta_u: np.ndarray, pad_idx: int):
        """Yield (positions, n_valid, host-input dict) per tier chunk:
        zero-copy views over the (already rung-padded) tier arrays; padding
        rows carry the out-of-range slot ``pad_idx`` and zero ratios."""
        pad = np.int32(pad_idx)
        g = len(tg.pos)
        for s, c in tg.slices:
            pos_c = tg.pos[s:min(s + c, g)]
            v = len(pos_c)
            pc = np.full(c, pad, np.int32)
            pc[:v] = slots32[pos_c]
            pm = np.zeros(c, np.float32)
            pm[:v] = 1.0
            td = np.zeros(c, np.float32)
            td[:v] = theta_d[pos_c]
            tu = np.zeros(c, np.float32)
            tu[:v] = theta_u[pos_c]
            yield pos_c, v, dict(
                parts=pc, pmask=pm, xs=tg.xs[s:s + c], ys=tg.ys[s:s + c],
                ws=tg.ws[s:s + c], ims=tg.ims[s:s + c], td=td, tu=tu)

    def _dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def step_ragged(self, global_f, store, parts: np.ndarray, tiers: list,
                    lr, theta_d, theta_u, t: int = 0):
        """Run one PLAN-SHAPED round: one batched step per tier chunk.
        Returns (new global [n_params], down_bits [P], up_bits [P],
        gnorms [P]) with per-participant outputs as numpy arrays in the
        caller's ``parts`` order; the updated rows land in ``store.pool``."""
        n = len(parts)
        n_params = self.spec.n_params
        slots32 = store.prepare(np.asarray(parts), t)
        g_cdf, g_max = self._hist(global_f)
        up_sum = torch.zeros(n_params, dtype=torch.float32,
                             device=self.device)
        lr = lr.to(self.device)
        pend = []
        for tg in tiers:
            key = (int(tg.b), int(tg.tau))
            self.tier_occupancy[key] = (self.tier_occupancy.get(key, 0)
                                        + len(tg.pos))
            for pos_c, v, a in self._tier_chunks(tg, slots32, theta_d,
                                                 theta_u, store.capacity):
                c = len(a["parts"])
                self.work_ragged += c * tg.tau * tg.b
                self._shapes_seen.add((c, int(tg.tau), int(tg.b)))
                pmask = self._dev(a["pmask"])
                ups, db, ub, gn = self._tier_chunk_defer(
                    store, global_f, g_cdf, g_max, a["parts"], v,
                    self._dev(a["xs"]), self._dev(a["ys"], torch.int64),
                    self._dev(a["ws"]), self._dev(a["ims"]), lr,
                    self._dev(a["td"]), self._dev(a["tu"]))
                weighted_row_fold(up_sum, ups, pmask)
                self.chunk_calls += 1
                pend.append((pos_c, v, torch.stack([db, ub, gn])))
        self.work_cap += n * self.tau_cap * self.b_cap
        self.rounds += 1
        new_global = self._finalize(global_f, up_sum, n)
        # end-of-round readback: every chunk step has been queued, so this
        # one copy drains the device queue — the round's single host sync
        outs = torch.cat([o for _, _, o in pend], dim=1).cpu().numpy()
        db_o = np.empty(n, np.float32)
        ub_o = np.empty(n, np.float32)
        gn_o = np.empty(n, np.float32)
        col = 0
        for (pos_c, v, o) in pend:
            db_o[pos_c] = outs[0, col:col + v]
            ub_o[pos_c] = outs[1, col:col + v]
            gn_o[pos_c] = outs[2, col:col + v]
            col += o.shape[1]
        return new_global, db_o, ub_o, gn_o
