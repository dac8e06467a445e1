"""Execution layer of the Track-A round engine — the port of
``repro.fl.executor``, for every scheme, unsharded or sharded.

**Ragged** (default): the host groups the round's participants by
quantized (b, τ) tier (`TierGroup`); `step_ragged` walks the tiers in
order and, for each **tier chunk** (≤ ``chunk`` participants, padded to a
rung of the chunk ladder), runs the per-participant round batched over the
chunk. **Masked** (``SimConfig.ragged=False``): `step` runs every
participant at the cap shape [τ, b_max] with zero-weight masks, over
fixed chunks of `chunk_layout`; the last chunk is padded to the chunk size.
Both run the same chunk step, `_tier_chunk_defer`:

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
   top-k sparsify of the upload target — or, for ProWD (``quantize``), a
   second hybrid compress, of the targets row by row (x per row, one
   launch), dequantized to sign·mean on the compressed slots. With error
   feedback (``CaesarConfig.use_error_feedback``) the target is the delta
   plus the participant's residual row, and what the compressor dropped
   (target − upload) becomes the new residual.

So a chunk step launches one histogram and one compress kernel for every
scheme, plus one recover for Caesar and one more compress for ProWD; each
round adds the global model's histogram (`kernel_launches`).

The uploads fold into the round's sum in fixed order (`weighted_row_fold`),
the participants' new rows are written back into the pool in place
(``index_copy_`` over the valid rows only), and `_finalize` applies the
mean. Padded rows of a chunk gather a clamped (valid) pool row, train with
zero masks and are never scattered or folded with non-zero weight. The
pool may be stored in bf16 (``SimConfig.buffer_dtype``): gathers upcast
to f32, scatters downcast through `core.compression.stochastic_round_cast`
(``SimConfig.stochastic_round``, default on) seeded per (round, chunk) from
the SeedSequence (seed, 3, t, i) — the reference's `_round_seed` — else
round to nearest even. The error-feedback pool stays f32.

`step_ragged_deferred` is the wire boundary's variant: the same chunk
stream, but each chunk's raw uploads come back for the server to decode
and aggregate (`repro_torch.fl.robust`), and a row-adoption mask keeps the
pre-round pool and residual rows of participants the server never
aggregates (unsharded only, as in the reference).

**Sharded** (``layout``, a `repro_torch.launch.mesh.DataGroup` of D
ranks): one rank per shard of the "data" layout, every rank running this
executor on the same host inputs. The round's participants are stratified
(``p_shard`` per shard, checked), the chunk comes from
``auto_chunk(n_params, p_shard, …)``, and each rank runs only its own
shard's rows: in a ragged round each tier's members are regrouped
shard-major and padded to a common rung decomposition (tier membership
comes from capability, not from the shard, so per-shard counts differ and
a rank may own no valid row of a chunk; it still makes the call), so every
rank makes the same chunk calls with the same seeds, each over its own
``c`` rows of the ``[D·c]`` chunk; a masked round runs each shard's
``p_shard`` participants over `chunk_layout(p_shard, chunk)`. Each rank
folds its uploads into a partial sum; `fixed_order_sum` adds the partials
in rank order and `_finalize` applies the mean on every rank, so the global
vector stays replicated bit for bit. Padding rows carry the out-of-range
slot and a zero mask, gather a clamped row of the rank's own segment, and
are never written (only each rank's valid prefix of a chunk is scattered).
The per-participant outputs are all-gathered once at the end of the round
(`_readback`). A world of 1 runs exactly the unsharded path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import batchsize as BS
from repro_torch.core import compression as C
from repro_torch.core import rng as RNG
from repro_torch.fl.robust import weighted_row_fold
from repro_torch.launch import mesh as MESH

BUFFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# extra f32 [chunk, n_params] arrays the EF carry keeps live in the chunk
# step (gathered residual rows + new ones) — the reference's auto_chunk input
EF_EXTRA_ARRAYS = 2.0


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
    over chunks. ``apply_fn(params, x)`` maps {name: [c, *shape]} parameter
    views and [c, B, ...] inputs to [c, B, n_classes] logits. ``use_ef``
    turns on the error-feedback residual (``ef_width = n_params``, else 0)."""

    def __init__(self, cfg, apply_fn, spec: C.FlatSpec, n_part: int,
                 device, quantize: bool = False, use_ef: bool = False,
                 layout: MESH.DataGroup | None = None):
        self.cfg = cfg
        self.apply_fn = apply_fn
        self.spec = spec
        self.device = torch.device(device)
        # scheme switches, fixed for the simulation: Fig.-3 recovery of the
        # download (Caesar only), ProWD's quantized upload, error feedback
        self.use_recovery = cfg.scheme == "caesar"
        self.quantize = bool(quantize)
        self.use_ef = bool(use_ef)
        self.ef_width = spec.n_params if self.use_ef else 0
        if cfg.buffer_dtype not in BUFFER_DTYPES:
            raise ValueError(f"unknown buffer_dtype {cfg.buffer_dtype!r}; "
                             f"want one of {tuple(BUFFER_DTYPES)}")
        self.buf_dtype = BUFFER_DTYPES[cfg.buffer_dtype]
        self.use_sr = (self.buf_dtype == torch.bfloat16
                       and cfg.stochastic_round)
        # the "data" layout: None unsharded; one rank per shard when sharded
        self.layout = layout
        self.n_dev = 1 if layout is None else layout.world
        self.rank = 0 if layout is None else layout.rank
        if n_part % self.n_dev:
            raise ValueError(f"participants ({n_part}) must divide evenly "
                             f"over {self.n_dev} shards")
        self.n_clients = cfg.n_clients
        self.rows_per_shard = self.n_clients // self.n_dev
        self.p_shard = n_part // self.n_dev
        chunk_size = cfg.chunk_size
        if chunk_size is None:
            chunk_size = C.auto_chunk(
                spec.n_params, self.p_shard, cfg.chunk_budget_mb,
                extra_arrays=EF_EXTRA_ARRAYS if self.use_ef else 0.0)
        self.chunk, _, self.n_chunks = C.chunk_layout(self.p_shard,
                                                      chunk_size)
        self.b_cap, self.tau_cap = cfg.caesar.b_max, cfg.caesar.tau
        self.b_min = cfg.caesar.b_min
        # telemetry: cumulative per-tier participant counts, the distinct
        # tier-chunk shapes run (per shard), plan-shaped vs cap work (rows
        # executed over every shard), and the number of this rank's chunk
        # steps and rounds (`kernel_launches` turns them into the launches
        # of each kernel on this rank)
        self.tier_occupancy: dict = {}
        self._shapes_seen: set = set()
        self.work_ragged = 0
        self.work_cap = 0
        self.chunk_calls = 0
        self.rounds = 0
        # the store of the latest step, whose eviction-error telemetry
        # `telemetry` surfaces
        self._last_store = None

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
        out = {"tier_occupancy": occ,
               "compiled_tier_shapes": len(self._shapes_seen),
               "shape_lattice_bound": self.shape_lattice_bound(),
               "work_fraction": (self.work_ragged / self.work_cap
                                 if self.work_cap else 1.0),
               "chunk_calls": self.chunk_calls,
               "rounds": self.rounds,
               "kernel_launches": self.kernel_launches()}
        # eviction-error telemetry is measured where the restores happen:
        # surface the store's numbers beside the executor's
        if self._last_store is not None:
            err = self._last_store.telemetry().get("restore_error")
            if err is not None:
                out["restore_error"] = err
        return out

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

    def participant_round(self, global_f, g_cdf, g_max, local, ef_row, xs,
                          ys, ws, ims, lr, theta_d, theta_u):
        """One round for each row of a chunk, on flat [c, n_params] rows
        (``ef_row`` is the residual rows, or None without error feedback).
        Returns (uploads, new rows, new residual rows or None, down bits,
        up bits, upload-delta norms)."""
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
        # upload (EF: compress the residual-corrected delta, keep what the
        # compressor dropped as the participant's new residual)
        target = delta + ef_row if self.use_ef else delta
        thr_u = C.fused_threshold(target, theta_u)
        if self.quantize:   # ProWD: 1-bit compressed slots at sign·mean
            k2, s2, c2, ss2, _ = C.fused_compress(target, thr_u)
            mean2 = ss2 / torch.clamp(c2, min=1).to(torch.float32)
            up = torch.where(s2 != 0, s2.to(torch.float32) * mean2[:, None],
                             k2)
            up_bits = C.hybrid_payload_bits(n_params, c2)
        else:               # top-k sparsification
            up, up_bits = C.topk_sparsify_at(target, thr_u)
        new_ef = target - up if self.use_ef else None
        return up, w_fin, new_ef, down_bits, up_bits, gnorm

    # -- the bf16 pool's stochastic-rounding scatter -------------------------

    def _round_seed(self, t: int, i: int = 0) -> int:
        """Per-(round, chunk) SR seed: the SeedSequence (seed, 3, t, i) —
        kinds 0/1 are the capability streams, 2 the round's sampling."""
        return int(RNG.sequence(self.cfg.seed, RNG.KIND_SR_SCATTER, t, i)
                   .generate_state(1)[0])

    def _store_cast(self, rows: torch.Tensor, seed: int) -> torch.Tensor:
        """f32 rows → the pool's dtype: stochastic rounding when enabled,
        the identity for f32 pools, round to nearest even otherwise."""
        if self.use_sr:
            return C.stochastic_round_cast(rows, self.buf_dtype, seed)
        return rows.to(self.buf_dtype)

    def _tier_chunk_defer(self, store, global_f, g_cdf, g_max, slots, n_valid,
                          xs, ys, ws, ims, lr, theta_d, theta_u, wmask=None,
                          seed: int = 0):
        """Gather the chunk's rows (upcast to f32), run the round, write the
        first ``n_valid`` rows back in place (downcast to the pool's dtype).
        ``wmask`` [c] (device) is the row-adoption mask: rows where it is 0
        rewrite their gathered pool and residual values (an SR fixed point,
        so unchanged). Returns the raw uploads [c, n_params] for the fold."""
        # slots → rows of this rank's segments; the pad slot (capacity)
        # clamps to the last owned row, gathered but never written
        idx = torch.from_numpy(np.minimum(
            slots.astype(np.int64) - store.row0,
            store.pool.shape[0] - 1)).to(self.device)
        local = store.pool.index_select(0, idx).to(torch.float32)
        ef = store.ef_pool.index_select(0, idx) if self.use_ef else None
        ups, new_rows, new_ef, db, ub, gn = self.participant_round(
            global_f, g_cdf, g_max, local, ef, xs, ys, ws, ims, lr, theta_d,
            theta_u)
        if wmask is not None:
            sel = wmask[:, None] > 0
            new_rows = torch.where(sel, new_rows, local)
            if self.use_ef:
                new_ef = torch.where(sel, new_ef, ef)
        keep = idx[:n_valid]
        store.pool.index_copy_(0, keep,
                               self._store_cast(new_rows[:n_valid], seed))
        if self.use_ef:
            store.ef_pool.index_copy_(0, keep, new_ef[:n_valid])
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

    def _resolve_slots(self, store, parts: np.ndarray, t: int) -> np.ndarray:
        """Activate the round's participants in the store (main thread) and,
        sharded, check the stratification. Returns the slots [P] int32."""
        self._last_store = store
        parts = np.asarray(parts)
        if self.n_dev > 1:
            counts = np.bincount(parts // self.rows_per_shard,
                                 minlength=self.n_dev)
            if not (counts == self.p_shard).all():
                raise ValueError(
                    "sharded mode needs stratified participants "
                    f"({self.p_shard} per shard; got {counts.tolist()})")
        return store.prepare(parts, t)

    def _tier_chunks(self, tg: TierGroup, slots32: np.ndarray,
                     theta_d: np.ndarray, theta_u: np.ndarray, pad_idx: int,
                     cap_per_shard: int):
        """Yield (positions by rank, this rank's host-input dict) per tier
        chunk. ``positions by rank`` holds, for every rank, the parts
        positions of its valid rows (a prefix of its ``c`` rows); padding
        rows carry the out-of-range slot ``pad_idx`` and zero ratios.
        Unsharded: zero-copy views over the (already rung-padded) tier
        arrays. Sharded: the tier's members regrouped by shard and padded
        to a rung decomposition common to every shard (the reference's)."""
        g = len(tg.pos)
        if self.n_dev == 1:
            for s, c in tg.slices:
                pos_c = tg.pos[s:min(s + c, g)]
                yield [pos_c], self._chunk_inputs(
                    pos_c, c, slots32, theta_d, theta_u, pad_idx,
                    tg.xs[s:s + c], tg.ys[s:s + c], tg.ws[s:s + c],
                    tg.ims[s:s + c])
            return
        owner = slots32[tg.pos] // cap_per_shard
        iloc = [np.flatnonzero(owner == s) for s in range(self.n_dev)]
        _, slices = self.tier_layout(max(len(il) for il in iloc))
        for s, c in slices:
            by_rank = [tg.pos[il[s:s + c]] for il in iloc]
            mine = iloc[self.rank][s:s + c]
            yield by_rank, self._chunk_inputs(
                by_rank[self.rank], c, slots32, theta_d, theta_u, pad_idx,
                *(_pad_rows(a[mine], c) for a in (tg.xs, tg.ys, tg.ws,
                                                  tg.ims)))

    @staticmethod
    def _chunk_inputs(pos_c, c, slots32, theta_d, theta_u, pad_idx, xs, ys,
                      ws, ims) -> dict:
        """One chunk's host inputs, its per-participant vectors padded to
        ``c`` rows (slot ``pad_idx``, zero mask and ratios)."""
        v = len(pos_c)
        pc = np.full(c, np.int32(pad_idx), np.int32)
        pc[:v] = slots32[pos_c]
        pm = np.zeros(c, np.float32)
        pm[:v] = 1.0
        td = np.zeros(c, np.float32)
        td[:v] = theta_d[pos_c]
        tu = np.zeros(c, np.float32)
        tu[:v] = theta_u[pos_c]
        return dict(parts=pc, pmask=pm, xs=xs, ys=ys, ws=ws, ims=ims, td=td,
                    tu=tu)

    def _dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def _run_chunk(self, store, global_f, g_cdf, g_max, a: dict, v: int, lr,
                   seed_i: int, t: int, wmask=None):
        """One chunk step from host inputs ``a`` (see `_chunk_inputs`)."""
        seed = self._round_seed(t, seed_i) if self.use_sr else 0
        ups, db, ub, gn = self._tier_chunk_defer(
            store, global_f, g_cdf, g_max, a["parts"], v,
            self._dev(a["xs"]), self._dev(a["ys"], torch.int64),
            self._dev(a["ws"]), self._dev(a["ims"]), lr,
            self._dev(a["td"]), self._dev(a["tu"]),
            wmask=None if wmask is None else self._dev(wmask), seed=seed)
        self.chunk_calls += 1
        return ups, torch.stack([db, ub, gn])

    def _tier_stream(self, global_f, store, slots32, tiers: list, lr,
                     theta_d, theta_u, t: int, wm=None):
        """Run every tier chunk in processing order; yield (positions by
        rank, c, pmask, uploads, [3, c] per-row outputs) for this rank's
        rows of each chunk."""
        g_cdf, g_max = self._hist(global_f)
        call_i = 0
        for tg in tiers:
            key = (int(tg.b), int(tg.tau))
            self.tier_occupancy[key] = (self.tier_occupancy.get(key, 0)
                                        + len(tg.pos))
            for by_rank, a in self._tier_chunks(
                    tg, slots32, theta_d, theta_u, store.capacity,
                    store.cap_per_shard):
                c = len(a["parts"])
                pos_c = by_rank[self.rank]
                v = len(pos_c)
                # the rows executed over every shard
                self.work_ragged += self.n_dev * c * tg.tau * tg.b
                self._shapes_seen.add((c, int(tg.tau), int(tg.b)))
                wm_c = None
                if wm is not None:
                    wm_c = np.zeros(c, np.float32)
                    wm_c[:v] = wm[pos_c]
                ups, outs = self._run_chunk(store, global_f, g_cdf, g_max, a,
                                            v, lr, call_i, t, wm_c)
                call_i += 1
                yield by_rank, c, a["pmask"], ups, outs

    def _readback(self, n: int, pend: list):
        """The per-participant outputs in parts order, as numpy: one
        all-gather of every rank's [3, Σc] chunk outputs (a plain copy in a
        world of 1) — after every chunk step has been queued, so it drains
        the device queue (the round's one host sync). ``pend`` holds
        (positions by rank, c, outputs) per chunk."""
        own = torch.cat([o for _, _, o in pend], dim=1)
        outs = torch.stack(MESH.fetch_global(own, self.layout)).cpu().numpy()
        res = np.empty((3, n), np.float32)
        for r in range(self.n_dev):
            col = 0
            for by_rank, c, _ in pend:
                pos = by_rank[r]
                res[:, pos] = outs[r, :, col:col + len(pos)]
                col += c
        return res[0], res[1], res[2]

    def _sum_shards(self, global_f, up_sum, n: int):
        """Algorithm 1 line 13 over every shard: the ranks' partial upload
        sums in rank order, then the mean over the round's ``n``
        participants (every rank's valid rows, known on every host)."""
        return self._finalize(global_f, MESH.fixed_order_sum(up_sum,
                                                             self.layout), n)

    def step_ragged(self, global_f, store, parts: np.ndarray, tiers: list,
                    lr, theta_d, theta_u, t: int = 0):
        """Run one PLAN-SHAPED round: one batched step per tier chunk.
        Returns (new global [n_params], down_bits [P], up_bits [P],
        gnorms [P]) with per-participant outputs as numpy arrays in the
        caller's ``parts`` order; the updated rows land in ``store.pool``."""
        n = len(parts)
        slots32 = self._resolve_slots(store, parts, t)
        up_sum = torch.zeros(self.spec.n_params, dtype=torch.float32,
                             device=self.device)
        lr = lr.to(self.device)
        pend = []
        for by_rank, c, pm, ups, outs in self._tier_stream(
                global_f, store, slots32, tiers, lr, theta_d, theta_u, t):
            weighted_row_fold(up_sum, ups, self._dev(pm))
            pend.append((by_rank, c, outs))
        self.work_cap += n * self.tau_cap * self.b_cap
        self.rounds += 1
        new_global = self._sum_shards(global_f, up_sum, n)
        return (new_global, *self._readback(n, pend))

    def step_ragged_deferred(self, global_f, store, parts: np.ndarray,
                             tiers: list, lr, theta_d, theta_u, t: int = 0,
                             wmask=None):
        """The wire boundary's `step_ragged`: the identical tier-chunk
        stream, but aggregation is DEFERRED — each chunk's raw uploads come
        back [c, n_params] (on the device) for the caller to serialize,
        transport and fold server-side (`repro_torch.fl.robust` replays the
        same fold, so a zero-fault round is bit-identical).

        ``wmask`` [P] bool (parts order) gates row adoption: participants
        whose upload the server never aggregates (dropouts, discarded
        stragglers, twice-corrupted payloads) keep their pre-round pool and
        residual rows. Returns (chunks, down_bits, up_bits, gnorms) with
        ``chunks`` the ordered list of (positions, valid rows, c, uploads)
        the server replays. Unsharded only: the wire boundary serializes
        per client, and a sharded one would need a server per shard."""
        if self.layout is not None:
            raise NotImplementedError("the wire-boundary round is "
                                      "single-mesh (set sharded=False)")
        n = len(parts)
        wm = (np.ones(n, np.float32) if wmask is None
              else np.asarray(wmask, np.float32))
        slots32 = self._resolve_slots(store, parts, t)
        lr = lr.to(self.device)
        chunks, pend = [], []
        for by_rank, c, _pm, ups, outs in self._tier_stream(
                global_f, store, slots32, tiers, lr, theta_d, theta_u, t,
                wm=wm):
            pos_c = by_rank[0]
            chunks.append((pos_c, np.arange(len(pos_c)), c, ups))
            pend.append((by_rank, c, outs))
        self.work_cap += n * self.tau_cap * self.b_cap
        self.rounds += 1
        return (chunks, *self._readback(n, pend))

    def step(self, global_f, store, parts: np.ndarray, xs, ys, ws, ims, lr,
             theta_d, theta_u, t: int = 0):
        """Run one MASKED round at the [τ, b_max] cap over fixed chunks of
        each shard's participants (`chunk_layout`; the last one padded to
        the chunk size). Same return contract as `step_ragged`."""
        n = len(parts)
        slots32 = self._resolve_slots(store, parts, t)
        g_cdf, g_max = self._hist(global_f)
        up_sum = torch.zeros(self.spec.n_params, dtype=torch.float32,
                             device=self.device)
        lr = lr.to(self.device)
        # each shard's participants in parts order (stratified draws come
        # shard-major, so these are contiguous runs of parts)
        order = np.argsort(np.asarray(parts) // self.rows_per_shard,
                           kind="stable")
        shard_pos = order.reshape(self.n_dev, self.p_shard)
        chunk = self.chunk
        pend = []
        for i in range(self.n_chunks):
            s = i * chunk
            by_rank = [p[s:s + chunk] for p in shard_pos]
            pos_c = by_rank[self.rank]
            arrs = [_pad_rows(_take_rows(a, pos_c), chunk)
                    for a in (xs, ys, ws, ims)]
            a = self._chunk_inputs(pos_c, chunk, slots32, theta_d, theta_u,
                                   store.capacity, *arrs)
            self._shapes_seen.add((chunk, self.tau_cap, self.b_cap))
            ups, outs = self._run_chunk(store, global_f, g_cdf, g_max, a,
                                        len(pos_c), lr, i, t)
            weighted_row_fold(up_sum, ups, self._dev(a["pmask"]))
            pend.append((by_rank, chunk, outs))
        self.rounds += 1
        new_global = self._sum_shards(global_f, up_sum, n)
        return (new_global, *self._readback(n, pend))


def _take_rows(a: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``a[pos]``: a view when ``pos`` is a run of consecutive rows (every
    unsharded chunk, and a stratified draw's shard), else a copy."""
    if len(pos) and (np.diff(pos) == 1).all():
        return a[pos[0]:pos[-1] + 1]
    return a[pos]


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``rows`` (a view when full)."""
    if len(a) == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out
