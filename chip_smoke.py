#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card: the Track-A Caesar
round on HAR (ragged, masked, error feedback with a bf16 pool, and sharded
over 4 ranks of a process group on the card), every
scheme of the paper on its CIFAR-10 ResNet-18 at full width, the wire
boundary (faults, robust aggregation) on ResNet-18, the capped client-state
store with eviction and offload, checkpoint/resume of the simulator,
serving Qwen1.5-4B at full width and Track-B training of it, and serving
and Track-B training of the LM zoo's other families at their published
widths (Mamba2, Zamba2, InternVL2, HuBERT, Llama-4-Scout and DeepSeek-V3,
the last two cut in depth), Track B over a pod mesh of 4 ranks on the
card, serving under a mesh of 4 and 2 ranks on the card, and the port's
invariant checker (runtime contracts and ownership audit) on the card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (and nvcc).
Phases, each of which fails the script on any error:

1. environment: the card's name and power limit (nvidia-smi); TF32 off;
2. build: compiles the four CUDA kernels from src/repro_torch/kernels/csrc,
   one nvcc per source, all at once;
3. kernels: each compression kernel against its plain PyTorch version on
   the card at the round's shapes (n = 164,134; the histogram, compress
   and recover at every chunk rung 1, 2, 4, 8, 16, 17 (the chunk with
   error feedback) and 25, compress on the shared global vector and on x
   per row, at the round's thresholds and at edge ones: 0, +inf, one equal
   to an |x|), with CUDA-event timings of kernel and plain version at
   every rung (the sharded ranks' tier chunks run each of them) and, for
   the histogram at 1 row, torch.histc as a yardstick, beside the bytes
   bound at 3.35 TB/s; and each kernel's own device time (``kernel_only_ms``, from
   a torch.profiler window of CUDA activity), which also shows that one
   call launches one CUDA kernel (checked for every kernel);
3b. kernels at the schemes path's widths: the same checks and timings at
   n = 11,164,362 (ResNet-18: rungs 1, 2, 4, 8, the histogram timed at 1
   and 8 rows) and n = 699,066
   (cnn_cifar: rungs 2 and 8), plus compress on x per row at per-row
   thresholds (ProWD's upload) at rungs 2 and 8 of the first and 8 of the
   second, each checked exact, run twice bit-identical and timed;
4. decode kernel: flash decode against its plain version at the serve
   shape (B=4, H=Hkv=20, D=128, S=48, bf16, every length 1..48), the
   serve example's direct call (B=2, H=8, Hkv=4, D=64, S=2048, f32), a
   long cache at full width (S=4096, bf16) and the families' serve shapes
   (S=48, bf16, every length): Llama-4-Scout H=40 over Hkv=8 (G = 5, in
   blocks of 8 query heads), Zamba2's shared block H=Hkv=32 and InternVL2
   H=16 over Hkv=8, timed as in phase 3 beside the
   bytes bound and torch's scaled_dot_product_attention with a length mask
   (a yardstick only; the port never calls it); one CUDA kernel per call.
   4b. the decode kernel's lse mode (phase 12's (e), below) at phase
   12's per-rank shapes.
   After phases 3 and 4 and the paths, the scratch the histogram,
   compress and decode kernels leave zeroed between calls must be all
   zeros;
5. parity: the small HAR config (12 clients) on cuda and on cpu within
   the port from one initial vector, for every scheme — participants,
   plans, sim_time and waiting identical, traffic within rtol 1e-5, the
   global vector after round 1 within 1e-6 and after later rounds within
   1e-4 (while at most 100 elements have flipped so far) outside the
   elements whose selection flipped, counted from each compress call's
   sign mask and each top-k's drop mask (an exact-zero delta has sign 0
   and a one-ulp delta ±1, so a sign change counts: the three ProWD flips
   of round 1 are such, and no payload bit shows them); round 1's compress
   calls on the card against the plain version on their own inputs, and
   each of round 1's compress flips an exact zero on one device against at
   most one ulp of its weight on the other; for caesar, prowd and pyramidfl
   two same-seed runs on cuda, and pipelined vs synchronous, bit-identical
   (deterministic kernels and cuDNN);
5b. modes parity: on the same config, cuda vs cpu for the masked engine
   (ragged=False), error feedback (caesar and prowd), the bf16 pool with
   stochastic rounding and the zero-fault loopback wire, with the gates of
   phase 5 (bf16: its own after round 1); a second same-seed card run of
   each bit-identical (global, pool, EF pool), and the loopback run
   bit-identical to the in-process one on the card;
6. round path: the dense HAR point (1000 clients, participation 0.5,
   τ = 5, b_max = 32, 4 rounds) with the launch counters zeroed just
   before and read just after — each must equal what the tier layout
   implies, and each kernel's launches per chunk rows must fall on the
   rungs phase 3 checked (so in every path below; 3b's at ResNet-18);
   then a profiled 1-round rerun for the time breakdown;
6f. sharded round engine (one rank per shard of the client-state pool):
   (a) the dense HAR point with ``sharded=True`` in a world of 1 (an NCCL
   group of one rank in this process: the layout's world-of-1 path, in
   which no collective runs), bit-identical to phase 6 (global vector,
   History) with the same launches; (b) the same point on 4 ranks of a
   gloo group (NCCL refuses two ranks on one card), all on cuda:0, started
   with torch.multiprocessing's spawn and joined within a time limit —
   every rank's History and round_log the same, its pool a segment of
   exactly ``cap_per_shard`` rows on cuda:0, its launches those the tier
   layout implies and on the rungs phase 3 checked, the global vector
   finite and the same on every rank; walls per round beside the card's
   name and power limit (4 ranks share one card: no scaling claim); (c)
   phase 5's config on the 4 ranks, cuda against cpu, ragged and masked,
   gated as phase 5 with the flips counted over every rank's selections;
6a. modes path: the same point for 3 rounds each ragged f32, masked f32,
   and ragged with error feedback and a bf16 pool (chunk 17) — launches
   against ``kernel_launches()``, round walls, peak memory; then one round
   each, unprofiled for its wall and again under the profiler for its
   device time and busy share;
6b. schemes path: fedavg, fic, cac, flexcom, prowd, pyramidfl and caesar,
   each for 3 rounds of ResNet-18 at width 64 (11,164,362 parameters) on
   cifar10 (100 clients, participation 0.1, data_scale 0.2, τ = 10,
   b_max = 32: chunk 8), the counters zeroed just before each run and read
   just after — histogram rounds + chunk steps, compress chunk steps (twice
   that for prowd), recover chunk steps for caesar and none otherwise —
   with round walls, traffic per round, sim_time and peak memory; then one
   round each of caesar and prowd, run unprofiled for its wall and again
   (same round) under the profiler for device time by kernel;
6c. wire path: ResNet-18 at width 64 on cifar10 (100 clients, 10 per
   round, τ 10, b_max 32, 3 rounds), Caesar with error feedback, a bf16
   pool, the loopback wire, trimmed-mean aggregation and faults (10%
   dropout, 5% corruption, 10% sign-flip attackers at ×10); then with the
   plain mean, and clean: serialized bytes equal to the exact payload
   model, fault counts, walls and peak memory, launches checked; the
   attacked mean must move further from the clean run than the trimmed
   mean; and fig11's robustness gate at its own config on the card;
7. serve path: Qwen1.5-4B at full width (40 layers, d_model 2560, bf16,
   random weights from a seeded generator on the card), 4 prompts × 16
   tokens then 32 greedy tokens, with the counters zeroed just before and
   read just after — the decode kernel must launch n_layers × 47 times;
   kernel-path vs plain-path logits over a teacher-forced sequence and
   decode vs prefill logits within stated tolerances; a warm rerun for
   latency, and 10 teacher-forced decode steps timed and then profiled
   for the device's busy share; then a long-cache window: a 4096-position
   cache filled from a seeded generator, 10 teacher-forced steps from
   length 4000, timed and profiled for the decode kernel's share, with the
   kernel path's last-step logits against the plain path's;
3c. kernels at the Track-B leaf widths (before any model is resident):
   the histogram, compress and recover on one row of every distinct leaf
   width, read from the port's init_abstract, of the models phases 8, 9
   and 10b train — Qwen1.5-4B (n = 707,788,800 the stacked FFN weights
   down to 2,560), the example's qwen-115m, Mamba2, Zamba2, HuBERT,
   InternVL2, Llama-4-Scout at depth 1 (up to 1,034,485,760, its
   embedding), DeepSeek-V3's smoke config and the leaf shards of phase
   11's full-width points — exact against the plain
   versions (Σ|x| within rtol 1e-5); at Qwen's and the example's widths
   and the widest (Llama-4-Scout's embedding) also one CUDA kernel per
   call and timed as in phase 3;
6d. capped store: the dense HAR point with state_capacity 640 (1.28× the
   cohort: every round after the first evicts) and host, then memmap
   offload, each bit-identical (global vector, History) to phase 6's
   uncapped run; without offload and with the restore-error probe: finite,
   evictions and centroid restores counted, restore_error reported; then
   the wire path's ResNet-18 point (trimmed mean, faults) with
   state_capacity 10 (the cohort) and memmap offload, bit-identical to its
   uncapped run of phase 6c, with exactly the restores from the spill that
   the draws imply (every earlier client drawn again outside the round
   before); walls, peak memory and the store's telemetry; the spill
   directory is deleted afterwards;
6e. resume: the capped dense HAR point with host offload cut after round
   2, and fig11's config through the loopback wire with faults and
   diurnal availability cut with deferred uploads in flight — each through
   state_dict → CheckpointManager.save → restore → a fresh Simulator's
   load_state_dict → run(start_round=cut + 1), bit-identical to the
   straight run (global vector, History tail, fault_log, avail_log);
6g. analysis: the port's invariant checker on the card
   (`repro_torch.analysis`): ``run_contracts`` — no f64 tensor in a round
   step, the pools written in place, the tier shapes on the lattice and
   no host sync but the sanctioned ones (end-of-round readback, the
   wire's per-chunk copy, the eval boundary), on the ragged, masked and
   wire engines of the reference's tiny config, and one Track-B step of
   Qwen1.5-4B's smoke config — and ``run_ownership`` (three pipelined
   runs), every report passing; the launch counters zeroed just before
   the contracts and read just after: each of the three compression
   kernels launched, exactly as the checked runs imply; then three
   violations seeded here into the ragged engine's chunk step, each of
   which exactly its own contract must flag: an f64 op, an extra
   ``.item()`` (the sync contract names this file's line), and the pool
   reallocated in place of written;
8. train path: Track-B training of Qwen1.5-4B at full width (bf16, 3.95 B
   parameters, random weights from a seeded generator) as
   ``python -m repro_torch.launch.train`` runs it: batch 8, seq 128, τ 1,
   θ_u 0.35, θ_d max 0.6, error feedback, 5 steps — loss finite at every
   step, the histogram twice and compress and recover once per leaf and
   step, all at one row and at widths phase 3c checked, every leaf's
   recovered download and sparse upload finite; ms per step, tokens/s,
   peak memory, and one more step profiled for the busy share and the
   compression kernels' share of device time;
9. train example: the Track-B example's qwen-115m (f32, TF32 off) — cuda
   vs cpu for 3 steps (loss within rtol 2e-6, every leaf within relative
   L2 1e-5 outside the selections flipped so far, counted from the sign
   and drop masks), then 30 steps of its learnable stream with the loss
   falling, the histogram twice and compress and recover once per leaf
   and step at one row and at widths phase 3c checked, and a
   CheckpointManager checkpoint after step 10, restored into a fresh
   state, whose steps 11–30 are bit-identical to the straight run;
10. serve the families: Mamba2-780M, Zamba2-1.2B and InternVL2-2B (text
   decode) at full size, Llama-4-Scout (depth 2) and DeepSeek-V3 (depth 2:
   one dense and one MoE MLA layer) at full width, bf16, random weights
   from a seeded generator, phase 7's shape through generate —
   decode_attention launched once per attention application and step
   (Llama-4 2, Zamba2's shared block 7, InternVL2 24; none for Mamba2 and
   DeepSeek's absorbed MLA), a same-seed rerun and two teacher-forced
   decodes bit-identical, the kernel path's logits against the plain
   path's and decode's against the forward's at the same positions (for
   a MoE: before each row's first token routed otherwise or dropped, and
   again against a forward with room for every token) within rel L2
   5e-2, or the model's bf16 noise floor where that is higher (its bf16
   forward against the same forward with f32 weights); ms per step,
   tokens/s, peak memory; a profiled window of Llama-4's decode;
10b. train the families: Track B as phase 8 runs it (batch 8, τ 1, θ_u
   0.35, θ_d max 0.6, EF), 3 steps each of Mamba2, Zamba2, HuBERT (audio
   frames [8, 128, 512]) and InternVL2 (seq 384: 256 patches + 128 text
   tokens) at full width, InternVL2 at full depth and the other three at
   depth 24, and Llama-4-Scout at depth 1 — finite losses, the histogram
   twice and compress and recover once per leaf and step at one row, every leaf width among phase 3c's, no
   non-finite recovered download or upload; ms per step, tokens/s, peak
   memory; one more Llama-4 step run twice from the same state,
   bit-identical; one profiled Zamba2 step; then DeepSeek-V3's smoke
   config cuda vs cpu for 3 steps (phase 9's bounds; its full width does
   not fit one card);
11. pod mesh: Track B over a ("pod", "data", "model") mesh on 4 gloo
   ranks sharing the card (`mesh.spawn`), each rank holding its shards
   of every leaf: (a) the reference's multipod config on (2, 2, 1) and
   Llama-4-Scout's smoke config on (1, 2, 2), 2 steps: the card's run
   twice bit-identical, and within loss rtol 2e-6, params rel. L2 1e-5
   and residuals 5e-4 outside at most 16 flips of the cpu ranks' run and
   of the meshless composition pod by pod on the card; (b) Qwen1.5-4B at
   full width and 4 layers on (2, 2, 1) with error feedback and (c)
   Llama-4-Scout at full width and depth 1 on (1, 2, 2) without error
   feedback, 2 steps each through ``train.run`` — per rank the histogram twice and compress and
   recover once per leaf shard and step at one row (shard widths checked
   in phase 3c), losses finite and the same on every rank, every shard's
   replicas bit-identical after every step, every expert shard under
   2^31; ms per step (the slowest rank), tokens/s, peak memory per rank;
12. serve mesh: serving and prefill under a ("data", "model") mesh of
   gloo ranks sharing the card, each rank holding its shards of the
   parameters and of the cache (`launch.specs.cache_specs`): (e), run as
   phase 4b, the decode kernel's lse mode against its plain version at
   each point's per-rank shapes (f32 3e-5, bf16 2e-2, lse 1e-5, the
   output bit-equal to the call without lse, the f32 output of bf16
   inputs rounding to it, one CUDA kernel), timed beside SDPA's
   lse-returning call (each kv head's query heads folded into its query
   length); (d) the (1, 1) local mesh
   bit-identical to mesh=None (Qwen1.5-4B at depth 2, 3 steps); then at
   published widths, bf16, against the meshless run on the card (which
   picks the greedy tokens every rank is fed): (a) Qwen1.5-4B at 2 of
   40 layers on (2, 2), batch 4 and kv heads split, prompt 4 then 4
   greedy tokens through make_serve_step plus make_prefill; (b) the same
   with one row and a cache seeded with 4,094 of its 4,096 positions,
   the sequence over "data", 2 steps (the partials merged across
   ranks); (c) Granite-34B at 1 layer on (1, 2), 2 ranks, its one kv
   head leaving the sequence to "model", batch 2, 1,022 of 1,024
   positions, 2 steps — logits rel. L2 5e-2 at every step, greedy tokens
   equal on at least 90%, seeded positions untouched, written ones within
   5e-2, ranks of a data block bit-identical, (f) the kernel launched
   once per attention layer and step on every rank and its plain version
   never; ms per step (the slowest rank), tokens/s, peak memory and
   cache bytes per rank;
13. census: `launch.dryrun`'s per-rank census on meta tensors, run in a
   worker process on the host from the end of the build (it needs no
   card), held to the card: phase 11(b)'s second step on each rank (its
   collectives in order with their group sizes and bytes, the
   parameter and state bytes it holds, equal; the census's peak within
   10% of `torch.cuda.max_memory_allocated` after a reset of the peak)
   and phase 12(a)'s first decode step (collectives, parameter and cache
   bytes equal, peak within 10%); (c) printed beside its census. Then
   the census alone of Qwen1.5-4B `train_4k` on (16, 16), Qwen1.5-4B on
   (2, 2, 1) at 8 and 12 layers as phase 11 runs it (four ranks' peaks
   against the card's memory), and DeepSeek-V3 `train_4k` and
   `decode_32k` on (16, 16) and (2, 16, 16);
14. exact operators: `core.compression`'s exact-quantile operators
   (`magnitude_threshold`, `compress_mask`, `hybrid_compress`/`recover`,
   `topk_sparsify`, the tree wrappers, `ef_compress`), cuda against cpu,
   bit-equal at n = 164,134 and at 2^25 + 3 (past torch.quantile's 2^24
   limit; the cpu side there in the census worker), mean_abs within
   rtol 1e-5.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. It exits non-zero without a CUDA device
or outside a checkout (it needs src/repro_torch beside it).
"""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import types

# keep CUPTI set up between profiler sessions: torch's default tears it
# down after each one, and a session that sets it up again now and then
# records no CUDA kernel (seen on the H100)
os.environ.setdefault("TEARDOWN_CUPTI", "0")
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 on the tensor cores, dense
N_PARAMS = 164134                # cnn_har
CHUNK = 25                       # auto_chunk at the dense HAR point
EF_CHUNK = 17                    # the same with error feedback's 2 arrays
# tier-chunk sizes the dense HAR point runs: the power-of-two tail rungs
# and the chunk, 25 ragged and masked, 17 with error feedback
RUNGS = (1, 2, 4, 8, 16, EF_CHUNK, CHUNK)
RESNET_RUNGS = (1, 2, 4, 8)      # the same at ResNet-18 width 64: chunk 8
SUM_RTOL = 1e-5                  # kernel vs plain Σ|x|: summation order
PARITY_REL_L2 = 1e-4             # cuda vs cpu global vector after 3 rounds
# cuda vs cpu global vector after round 1, outside the flipped elements:
# 10x the worst measured after three rounds (1.0e-7, H100)
PARITY_ROUND1_REL_L2 = 1e-6
# flips (cumulative over the rounds) past which a threshold-quantized
# scheme's cuda and cpu trajectories have separated: the rounds from there
# on are reported, not gated. ProWD on phase 5's config: 3 flips in round
# 1, 1 in round 2, then 1585 in round 3 (H100)
FLIP_CASCADE = 100
# decode kernel vs its plain version (the reference's own tolerances):
# f32 — the online softmax sums in another order; bf16 — one bf16 ulp of
# the output is 2^-8 relative
DECODE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SERVE_ARCH = "qwen1.5-4b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 16, 32
# serve-path logits, bf16 model, relative L2 per step over [B, vocab].
# Two bf16 evaluations of the same function differ by this model's bf16
# noise floor: kernel and plain paths differ where one attention output
# rounds to the other bf16 neighbour (unit roundoff 2^-9), decode and
# prefill in every matmul's summation order, and 40 random layers amplify
# either to ~2e-2 (measured on the H100: kernel vs plain 0.0188, decode
# vs prefill 0.0199 and 0.0195). The bound is 2.5× that floor; a wrong
# mask, scale or head grouping moves whole attention outputs and the
# logits by O(1). Greedy tokens must agree on most steps besides.
SERVE_REL_L2 = 5e-2
SERVE_ARGMAX_AGREE = 0.9
PROFILE_STEPS = 10               # decode steps in the serve profile window
# long-cache serve window: teacher-forced steps from LONG_START positions
# into a cache of LONG_CACHE, filled from a seeded generator
LONG_CACHE, LONG_START, LONG_STEPS = 4096, 4000, 10
KERNEL_ONLY_CALLS = 10           # calls in each kernel_only_ms window
WINDOW_ATTEMPTS = 3              # runs of a timing window the host stalled
PROFILE_ATTEMPTS = 5             # runs of a profiled window that records nothing
LOST_EVENT_ATTEMPTS = 2          # runs of a kernel_only window short of a record
PROFILE_PAD_S = 0.05             # host time around a profiled window's launches
PROFILE_KEEP = 0.95              # share of a serve window's events kept


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class _Timer:
    """Device milliseconds of one call, from CUDA events.

    Each window is ``iters`` calls, each after an L2 flush (a 64 MiB
    memset), recorded between two events while a leading ``_sleep``
    kernel keeps the card busy long enough for the host to enqueue the
    whole window — so host dispatch never leaks into the measurement. A
    flush-only window follows each one; the result is the median over
    ``windows`` pairs of (window − flush-only window) / iters. A window
    whose enqueueing outlasted the lead (a host stall: the card may have
    idled inside it) is run again, up to WINDOW_ATTEMPTS times."""

    def __init__(self, torch, flush, windows: int = 11, iters: int = 10,
                 lead_ms: float = 20.0):
        self.torch, self.flush = torch, flush
        self.windows, self.iters, self.lead_ms = windows, iters, lead_ms
        probe = 10_000_000
        a, b = self._events()
        a.record()
        torch.cuda._sleep(probe)
        b.record()
        b.synchronize()
        self.cycles = int(probe * lead_ms / max(a.elapsed_time(b), 1e-3))

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def _window(self, fn) -> float:
        for _ in range(WINDOW_ATTEMPTS):
            a, b = self._events()
            self.torch.cuda._sleep(self.cycles)
            t0 = time.perf_counter()
            a.record()
            for _ in range(self.iters):
                self.flush.zero_()
                if fn is not None:
                    fn()
            b.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if host_ms < self.lead_ms:
                return a.elapsed_time(b)
        raise RuntimeError(f"the host took {host_ms:.1f} ms to enqueue one "
                           f"timing window, {WINDOW_ATTEMPTS} times running; "
                           "the card may have idled")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        self.torch.cuda.synchronize()
        per = sorted((self._window(fn) - self._window(None)) / self.iters
                     for _ in range(self.windows))
        return per[len(per) // 2]


def _bound(bytes_moved: float, ops: float,
           ops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The least time of the work: its bytes over HBM's rate or its
    operations over the peak rate of their type (f32 by default), the
    larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _union_s(spans) -> float:
    """Seconds covered by the union of (start, end) µs intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


@dataclasses.dataclass
class _DeviceEvents:
    """The CUDA events of one name in a profiled window: how many ran and
    their summed device microseconds (the fields of a row of torch's
    ``key_averages()`` that this script reads)."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def _profile_once(torch, run, pad_s: float):
    """torch.profiler over ``run()``, CUDA activity only (CPU operator
    events would only slow the trace), with ``pad_s`` seconds of host time
    before the first launch and after the last kernel ends: without them
    the tracer now and then delivers none of a short window's kernels
    (seen on the H100 after the timer's windows, with the tracer slow to
    start). The trace's raw events are summed by name here: torch's
    ``key_averages()`` builds an object tree of every event first, which
    took 5.9–6.4 s for a window of 30,000 kernels against 0.7–0.8 s to
    read and walk the raw events (H100 host, tools/probe_profiler.py),
    and a dense HAR round's profile ~15 s. Returns the per-name CUDA
    events (kernels, memsets, copies; not user annotations), sorted by
    device time, and the window: the host seconds of ``run()`` under the
    profiler and the seconds in which at least one CUDA event ran
    (``busy_s``, the union of their intervals)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        time.sleep(pad_s)
    by_name, spans = {}, []
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != DeviceType.CUDA or ev.is_user_annotation()
                or ev.is_hidden_event() or _filter_name(ev.name())):
            continue
        start, end = ev.start_ns() / 1e3, ev.end_ns() / 1e3
        spans.append((start, end))
        name = _rewrite_name(name=ev.name(), with_wildcard=True)
        row = by_name.setdefault(name, _DeviceEvents(name))
        row.count += 1
        row.self_device_time_total += end - start
    events = sorted(by_name.values(), reverse=True,
                    key=lambda ev: ev.self_device_time_total)
    return events, {"profiled_run_s": run_s, "busy_s": _union_s(spans)}


def _event_table(events) -> str:
    """A profiled window's CUDA events as a text table, by device time."""
    total = sum(ev.self_device_time_total for ev in events) or 1.0
    lines = [f"{'name':<100} {'calls':>8} {'device ms':>12} "
             f"{'us/call':>10} {'share':>7}"]
    for ev in events[:40]:
        lines.append(f"{ev.key[:100]:<100} {ev.count:>8} "
                     f"{ev.self_device_time_total / 1e3:>12.3f} "
                     f"{ev.self_device_time_total / ev.count:>10.2f} "
                     f"{ev.self_device_time_total / total:>7.1%}")
    return "\n".join(lines) + "\n"


def _cuda_events(torch, run, table_name: str | None = None,
                 window: dict | None = None):
    """The CUDA events of ``run()`` (see `_profile_once`). A window that
    records nothing is run again with longer pads, up to PROFILE_ATTEMPTS
    times, and then the script fails. The table goes to
    OUT_DIR/<table_name> if given; ``window``, if given, gets the
    window's host seconds and union of device intervals."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        events, win = _profile_once(torch, run, PROFILE_PAD_S * attempt)
        if events:
            break
        print(f"note: the profiler recorded no CUDA kernel (attempt "
              f"{attempt} of {PROFILE_ATTEMPTS})", file=sys.stderr)
    check(bool(events), "the profiler recorded no CUDA kernel in "
          f"{PROFILE_ATTEMPTS} runs of one window")
    if table_name:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, table_name), "w") as f:
            f.write(_event_table(events))
    if window is not None:
        window.update(win)
    return events


_FLUSH_KEYS: dict = {}


def _kernel_only(torch, flush, fn, calls: int = KERNEL_ONLY_CALLS) -> dict:
    """fn's own device time: a torch.profiler window of ``calls`` calls,
    each after an L2 flush. The flush here is an in-place bitwise_not of
    the timer's flush buffer (the same 64 MiB written as its zero_); its
    own kernels, found by profiling it alone once per buffer, are dropped
    by name. Returns the ms per call of every other kernel, memset and
    copy on the card, and per name the launches per call and ms per
    launch."""
    flush_op = flush.view(torch.int32).bitwise_not_
    key = (flush.data_ptr(), flush.numel())
    if key not in _FLUSH_KEYS:
        _FLUSH_KEYS[key] = {ev.key for ev in _cuda_events(torch, flush_op)}
    flush_keys = _FLUSH_KEYS[key]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(calls):
            flush_op()
            fn()
    # a window in which the profiler lost an event (a kernel seen fewer
    # times than a whole number of calls) is profiled again; if it loses
    # one again (at n = 637,534,208 on the H100 it lost one record in
    # every window of 10 calls, of whichever kernel), a kernel's launches
    # per call are its count over the calls rounded, and its time per
    # call its time per recorded launch times those launches
    for _ in range(LOST_EVENT_ATTEMPTS):
        events = [ev for ev in _cuda_events(torch, window)
                  if ev.key not in flush_keys]
        lost = any(ev.count % calls for ev in events)
        if not lost:
            break
    by_name, total = {}, 0.0
    for ev in events:
        per_launch = ev.self_device_time_total / 1e3 / ev.count
        total += per_launch * max(1, round(ev.count / calls))
        by_name[ev.key] = {"launches_per_call": ev.count / calls,
                           "ms_per_launch": per_launch}
    check(bool(by_name), "the profiled window holds only the flush")
    return {"kernel_only_ms": total, "kernels": by_name,
            "profiler_lost_events": lost}


def _one_kernel(name: str, prof: dict) -> None:
    """A redesigned kernel's call is one CUDA kernel: no fill, memset or
    second pass beside it (launches per call rounded where the profiler
    lost a record: a second kernel would show as a second name, or as
    about 2 launches per call)."""
    per = next(iter(prof["kernels"].values()))["launches_per_call"]
    check(len(prof["kernels"]) == 1 and round(per) == 1
          and (per == 1 or prof["profiler_lost_events"]),
          f"{name}: one call launched {prof['kernels']}, want one kernel")


def _scratch_zeroed(torch, build, after: str) -> None:
    """Every buffer of `build.zeroed_scratch` is all zeros again: the
    kernels that merge their blocks in one launch leave it so, and their
    next call depends on it."""
    torch.cuda.synchronize()
    for key, buf in build._ZEROED.items():
        check(not bool(buf.any()), f"after {after}: the zeroed scratch "
              f"{key[0]} holds {int(buf.count_nonzero())} non-zero words")


def phase_kernels(torch, K, timer, n=N_PARAMS, rungs=RUNGS,
                  hist_rows=RUNGS, per_row_timed=(), timed=True):
    """Each compression kernel vs its plain version at a path's shapes:
    the histogram, compress and recover at every chunk rung in ``rungs``
    (the histogram timed at ``hist_rows``: the global model at 1 row, a
    chunk of upload deltas; at n = 164,134 every rung, since the sharded
    ranks' tier chunks launch it at every rung); at the rungs in ``per_row_timed`` compress is
    also timed on x per row at per-row thresholds (ProWD's upload) and run
    twice to show same-input calls bit-identical. Defaults: the dense HAR
    point (n = 164,134, drawn on the CPU); wider n are drawn on the card.
    ``timed=False`` makes the same checks and times nothing (its results
    hold the errors and bounds, and None for every time)."""
    from repro_torch.core import compression as C
    from repro_torch.kernels import hybrid_compress as HC
    from repro_torch.kernels import recover as RC
    from repro_torch.kernels import topk_threshold as TT

    dev = torch.device("cuda")
    on_card = n != N_PARAMS
    gen = torch.Generator(device=dev if on_card else "cpu").manual_seed(0)

    def randn(rows):
        r = torch.randn(rows, n, generator=gen, device=gen.device)
        return r.to(dev)

    results = {}
    for rows in rungs:
        x = randn(rows) * 0.05
        mx = torch.amax(x.abs(), dim=-1)
        # histogram (the global model at rows=1, upload deltas at every
        # chunk rung), timed at ``hist_rows``
        hk = TT.magnitude_histogram(x, mx)
        hp = TT.magnitude_histogram_plain(x, mx)
        torch.cuda.synchronize()
        check(torch.equal(hk, hp), f"histogram rows={rows}: counts differ")
        check(int(hk.sum()) == rows * n, "histogram lost elements")
        if rows in hist_rows and not timed:
            bms, by = _bound(rows * n * 4 + rows * 4 + rows * 256 * 4,
                             2.0 * rows * n)
            results[("magnitude_histogram", rows)] = dict(
                max_abs_err=float((hk - hp).abs().max()), bound_ms=bms,
                bound_by=by, **_UNTIMED)
        elif rows in hist_rows:
            ms = timer.ms(lambda: TT.magnitude_histogram(x, mx))
            own = _kernel_only(torch, timer.flush,
                               lambda: TT.magnitude_histogram(x, mx))
            _one_kernel("magnitude_histogram", own)
            plain = timer.ms(lambda: TT.magnitude_histogram_plain(x, mx))
            lib = lib_own = None
            if rows == 1:
                m = float(mx[0])

                def histc():
                    return torch.histc(x[0].abs(), bins=256, min=0.0, max=m)
                lib = timer.ms(histc)
                lib_own = _kernel_only(torch, timer.flush, histc)
            bms, by = _bound(rows * n * 4 + rows * 4 + rows * 256 * 4,
                             2.0 * rows * n)
            results[("magnitude_histogram", rows)] = dict(
                max_abs_err=float((hk - hp).abs().max()), ms=ms,
                kernel_only_ms=own["kernel_only_ms"], plain_ms=plain,
                library_ms=lib, library_kernel_only_ms=(
                    lib_own["kernel_only_ms"] if lib_own else None),
                bound_ms=bms, bound_by=by,
                grid=TT.hist_plan(rows, n, _sm_count(torch)),
                profile=own["kernels"],
                library_profile=lib_own["kernels"] if lib_own else None)

        # compress of the shared global vector at per-row thresholds from
        # download ratios θ_d across their range [0, θ_d max = 0.6] (one
        # row: 0.3, a mid-range ratio), as the main path computes them; it
        # is timed. Checked also on x per row and at edge thresholds: the
        # first row compresses nothing (thr 0), the last everything (thr
        # +inf) and another sits exactly on an |x|
        g = x[0].contiguous()
        gcdf, gmx = C.fused_histogram_cdf(g)
        ratio = (torch.linspace(0.0, 0.6, rows, device=dev) if rows > 1
                 else torch.full((1,), 0.3, device=dev))
        thr = C.threshold_from_cdf(gcdf, gmx, ratio)
        edge = thr.clone()
        edge[0] = 0.0
        if rows > 1:
            edge[-1] = float("inf")
        if rows > 2:
            edge[1] = g.abs()[n // 2]
        local = (g + randn(rows) * 0.01).contiguous()
        sum_err = rec_err = 0.0
        for src, t in ((x, edge), (g, edge), (x, thr), (g, thr)):
            ck = HC.hybrid_compress(src, t)
            cp = HC.hybrid_compress_plain(src, t)
            torch.cuda.synchronize()
            what = (f"compress rows={rows} x "
                    f"{'shared' if src is g else 'per row'}"
                    f"{' edge thresholds' if t is edge else ''}")
            for i, name in ((0, "kept"), (1, "sign"), (2, "count"),
                            (4, "max")):
                check(torch.equal(ck[i], cp[i]), f"{what}: {name} differs "
                      "from the plain version")
            if t is thr:
                check(bool((ck[2][ratio > 0] > 0).all()), f"{what}: a row "
                      "with a download ratio above 0 compressed nothing")
            err = (ck[3] - cp[3]).abs()
            check(bool((err <= SUM_RTOL * cp[3].abs() + 1e-30).all()),
                  f"{what}: sum_abs outside rtol {SUM_RTOL}")
            sum_err = max(sum_err, float(err.max()))
            # recover against stale local rows with these scalars
            kept, sign, cnt, ssum, smax = ck
            mean = ssum / torch.clamp(cnt, min=1).float()
            rk = RC.recover(kept, sign, local, mean, smax)
            rp = RC.recover_plain(kept, sign, local, mean, smax)
            torch.cuda.synchronize()
            check(torch.equal(rk, rp), f"recover after {what}: output "
                  "differs from the plain version")
            rec_err = max(rec_err, float((rk - rp).abs().max()))
        bms, by = _bound(n * 4 + rows * 4 + rows * n * 5 + rows * 12,
                         3.0 * rows * n)
        if rows in per_row_timed:
            results[("hybrid_compress_per_row", rows)] = _per_row_compress(
                torch, timer, HC, C, x, timed)
        rbms, rby = _bound(rows * n * 9 + rows * 8 + rows * n * 4,
                           4.0 * rows * n)
        if not timed:
            results[("hybrid_compress", rows)] = dict(
                max_abs_err=sum_err, bound_ms=bms, bound_by=by, **_UNTIMED)
            results[("recover", rows)] = dict(
                max_abs_err=rec_err, bound_ms=rbms, bound_by=rby,
                **_UNTIMED)
            continue
        ms = timer.ms(lambda: HC.hybrid_compress(g, thr))
        own = _kernel_only(torch, timer.flush,
                           lambda: HC.hybrid_compress(g, thr))
        _one_kernel(f"hybrid_compress rows={rows}", own)
        plain = timer.ms(lambda: HC.hybrid_compress_plain(g, thr))
        results[("hybrid_compress", rows)] = dict(
            max_abs_err=sum_err, ms=ms,
            kernel_only_ms=own["kernel_only_ms"], plain_ms=plain,
            library_ms=None, bound_ms=bms, bound_by=by,
            grid=HC.compress_plan(rows, n, _sm_count(torch)),
            profile=own["kernels"])

        # recover timed on the shared compression's outputs (the loop's
        # last ones)
        ms = timer.ms(lambda: RC.recover(kept, sign, local, mean, smax))
        own = _kernel_only(torch, timer.flush,
                           lambda: RC.recover(kept, sign, local, mean, smax))
        _one_kernel(f"recover rows={rows}", own)
        plain = timer.ms(lambda: RC.recover_plain(kept, sign, local, mean,
                                                  smax))
        results[("recover", rows)] = dict(
            max_abs_err=rec_err, ms=ms,
            kernel_only_ms=own["kernel_only_ms"], plain_ms=plain,
            library_ms=None, bound_ms=rbms, bound_by=rby,
            grid=RC.recover_plan(rows, n, _sm_count(torch)),
            profile=own["kernels"])
    for (name, rows), r in sorted(results.items()):
        print(f"kernel {name} rows={rows} n={n}: " + json.dumps(r))
    return results


# the times of a kernel check made with timed=False
_UNTIMED = dict(ms=None, kernel_only_ms=None, plain_ms=None, library_ms=None)


def _per_row_compress(torch, timer, HC, C, x, timed=True) -> dict:
    """Compress on x per row at per-row thresholds from each row's own
    histogram, at upload ratios θ_u across [0.1, 0.6] (ProWD's upload):
    exact against the plain version (Σ|x| within SUM_RTOL), two calls
    bit-identical, one CUDA kernel per call; timed as in phase 3 (with
    ``timed``)."""
    rows, n = x.shape
    ratio = torch.linspace(0.1, 0.6, rows, device=x.device)
    thr = C.fused_threshold(x, ratio)
    ck = HC.hybrid_compress(x, thr)
    again = HC.hybrid_compress(x, thr)
    cp = HC.hybrid_compress_plain(x, thr)
    torch.cuda.synchronize()
    what = f"compress rows={rows} n={n} x per row"
    for i, name in ((0, "kept"), (1, "sign"), (2, "count"), (4, "max")):
        check(torch.equal(ck[i], cp[i]), f"{what}: {name} differs from the "
              "plain version")
    check(all(torch.equal(a, b) for a, b in zip(ck, again)),
          f"{what}: two calls on the same input differ")
    check(bool((ck[2] > 0).all()), f"{what}: a row compressed nothing")
    err = (ck[3] - cp[3]).abs()
    check(bool((err <= SUM_RTOL * cp[3].abs() + 1e-30).all()),
          f"{what}: sum_abs outside rtol {SUM_RTOL}")
    bms, by = _bound(rows * n * 4 + rows * 4 + rows * n * 5 + rows * 12,
                     3.0 * rows * n)
    if not timed:
        return dict(max_abs_err=float(err.max()), bound_ms=bms, bound_by=by,
                    count_max=int(ck[2].max()), **_UNTIMED)
    ms = timer.ms(lambda: HC.hybrid_compress(x, thr))
    own = _kernel_only(torch, timer.flush, lambda: HC.hybrid_compress(x, thr))
    _one_kernel(what, own)
    plain = timer.ms(lambda: HC.hybrid_compress_plain(x, thr))
    # a yardstick for the stores alone: PyTorch's fills of the two outputs
    # (the same bytes written, nothing read, no fold)
    kept, sign = ck[0], ck[1]

    def fills():
        kept.fill_(0.0)
        sign.fill_(0)
    fill = _kernel_only(torch, timer.flush, fills)
    return dict(max_abs_err=float(err.max()), ms=ms,
                kernel_only_ms=own["kernel_only_ms"], plain_ms=plain,
                library_ms=None, bound_ms=bms, bound_by=by,
                fills_kernel_only_ms=fill["kernel_only_ms"],
                count_max=int(ck[2].max()),
                grid=HC.compress_plan(rows, n, _sm_count(torch),
                                      shared=False),
                profile=own["kernels"])


def _sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _sdpa(torch, q, k, v, mask):
    """torch's scaled_dot_product_attention on the decode kernel's layout
    (q [B,H,D], cache [B,S,Hkv,D]) with a boolean length mask [B,1,1,S]."""
    import torch.nn.functional as F
    h, hkv = q.shape[1], k.shape[2]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=h != hkv)[:, :, 0, :]


DECODE_SHAPES = {
    # name: (B, H, Hkv, D, S, dtype, lengths)
    "serve": (4, 20, 20, 128, 48, "bfloat16", None),
    "example": (2, 8, 4, 64, 2048, "float32", (2048, 1024)),
    "long": (4, 20, 20, 128, 4096, "bfloat16", None),
    # the families' serve points (phase 10): G = 5 (blocks of 8 query
    # heads, 3 idle), G = 1 (Zamba2's shared block), G = 2
    "llama4": (4, 40, 8, 128, 48, "bfloat16", None),
    "zamba2": (4, 32, 32, 128, 48, "bfloat16", None),
    "internvl2": (4, 16, 8, 128, 48, "bfloat16", None),
}


def phase_decode(torch, timer):
    """The flash-decode kernel vs its plain version on the card."""
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for name, (b, h, hkv, d, s, dt, lens) in DECODE_SHAPES.items():
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        tol = DECODE_TOL[dt]
        # correctness: the given lengths, or every length 1..S in turn
        sweeps = ([lens] if lens else
                  [[min(s, i + j) for j in range(b)]
                   for i in range(1, s + 1, b)])
        err = 0.0
        for lv in sweeps:
            length = torch.tensor(lv, dtype=torch.int32, device=dev)
            got = FA.decode_attention(q, k, v, length)
            want = FA.decode_attention_plain(q, k, v, length)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            check(bool((diff <= tol + tol * want.float().abs()).all()),
                  f"decode {name} lengths {lv}: kernel vs plain outside "
                  f"{tol} (max {float(diff.max()):.3g})")
            check(torch.equal(FA.decode_attention(q, k, v, length), got),
                  f"decode {name}: two runs on the same input differ")
            err = max(err, float(diff.max()))
        # timing at the full cache (the serve loop's last step) or the
        # example's lengths
        lv = list(lens) if lens else [s] * b
        length = torch.tensor(lv, dtype=torch.int32, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None]
                )[:, None, None, :]
        lib_out = _sdpa(torch, q, k, v, mask)
        want = FA.decode_attention_plain(q, k, v, length)
        lib_err = float((lib_out.float() - want.float()).abs().max())
        ms = timer.ms(lambda: FA.decode_attention(q, k, v, length))
        own = _kernel_only(torch, timer.flush,
                           lambda: FA.decode_attention(q, k, v, length))
        _one_kernel(f"decode_attention {name}", own)
        plain = timer.ms(lambda: FA.decode_attention_plain(q, k, v, length))
        lib = timer.ms(lambda: _sdpa(torch, q, k, v, mask))
        lib_own = _kernel_only(torch, timer.flush,
                               lambda: _sdpa(torch, q, k, v, mask))
        es = q.element_size()
        valid = sum(min(x, s) for x in lv)
        bytes_moved = (2 * b * h * d * es + 2 * valid * hkv * d * es
                       + 4 * b)
        flops = 4.0 * valid * h * d
        bms, by = _bound(bytes_moved, flops, F32_FLOPS if dt == "float32"
                         else BF16_FLOPS)
        results[name] = dict(
            shape=f"q[{b},{h},{d}] kv[{b},{s},{hkv},{d}] {dt} "
                  f"lengths {lv if len(lv) <= 4 else 'full'}",
            max_abs_err=err, ms=ms, kernel_only_ms=own["kernel_only_ms"],
            plain_ms=plain, library_ms=lib,
            library_kernel_only_ms=lib_own["kernel_only_ms"],
            library_max_abs_err=lib_err, bound_ms=bms, bound_by=by,
            plan=FA.plan(b, h, hkv, d, s, q.element_size(),
                         _sm_count(torch))._asdict(),
            profile=own["kernels"], library_profile=lib_own["kernels"])
        print(f"kernel decode_attention {name}: " + json.dumps(results[name]))
    return results


# schemes held cuda vs cpu on the small HAR config, and those whose two
# same-seed card runs (and pipelined vs synchronous loop) must agree bit for
# bit: Caesar, ProWD (compress on x per row) and PyramidFL (varying τ tiers,
# planned on the main thread)
PARITY_SCHEMES = ("caesar", "fedavg", "fic", "cac", "flexcom", "prowd",
                  "pyramidfl")
RERUN_SCHEMES = ("caesar", "prowd", "pyramidfl")
TOPK_ELEMENT_BITS = 64           # index + f32 value of a top-k element
HYBRID_ELEMENT_BITS = 31         # f32 value less its 1-bit sign


def _bit_flips(scheme: str, a: dict, b: dict) -> int:
    """Elements whose compression selection differs between two runs in one
    round, as the payload bits show them (``round_log`` entries; one top-k
    element: 64 bits; one hybrid element: 31). A lower bound: two flips
    that cancel within one payload leave the bits equal."""
    up = HYBRID_ELEMENT_BITS if scheme == "prowd" else TOPK_ELEMENT_BITS
    n = (float(abs(a["down_bits"] - b["down_bits"]).sum())
         / HYBRID_ELEMENT_BITS
         + float(abs(a["up_bits"] - b["up_bits"]).sum()) / up)
    check(n == int(n), "a payload differs by other than whole elements")
    return int(n)


class _Masks:
    """Records, per call of ``C.fused_compress`` and ``C.topk_sparsify_at``
    while installed, the selection each call made: the int8 sign mask of a
    compress (0 marks a full-precision slot) or the dropped mask of a
    top-k; ``ends[r]`` is the number of calls when round r + 1 ended. In the
    first ``keep_rounds`` rounds it also keeps each compress call's inputs
    and outputs on the device (``first``), for the kernel-vs-plain check on
    the round's own tensors."""

    def __init__(self, C, keep_rounds: int = 1):
        self.C, self.keep_rounds = C, keep_rounds
        self.calls, self.ends, self.first = [], [], []

    def install(self, sim, step_name: str = "step_ragged"):
        """Wrap ``sim``'s round step (``step_ragged`` or ``step`` of its
        executor, or its own ``_wire_round``), whose first output is the
        round's new global vector."""
        C, fc, tk = self.C, self.C.fused_compress, self.C.topk_sparsify_at
        owner = sim if step_name == "_wire_round" else sim.executor
        step = getattr(owner, step_name)
        sim.globals_per_round = []

        def compress(x, thr):
            out = fc(x, thr)
            self.calls.append(("compress", out[1].cpu(), x.dim()))
            if len(self.ends) < self.keep_rounds:
                self.first.append((x.clone(), thr.clone(),
                                   [o.clone() for o in out]))
            return out

        def topk(g, thr):
            self.calls.append(("topk", (g.abs() < thr.reshape(-1, 1)).cpu(),
                               g.dim()))
            return tk(g, thr)

        def rec(*a, **k):
            C.fused_compress, C.topk_sparsify_at = compress, topk
            try:
                out = step(*a, **k)
            finally:
                C.fused_compress, C.topk_sparsify_at = fc, tk
            self.ends.append(len(self.calls))
            sim.globals_per_round.append(out[0].detach().to("cpu",
                                                            copy=True))
            return out
        setattr(owner, step_name, rec)
        sim.masks = self
        return sim

    def round_calls(self, r: int) -> list:
        return self.calls[(self.ends[r - 2] if r > 1 else 0):
                          self.ends[r - 1]]


def _mask_flips(ma: _Masks, mb: _Masks, r: int) -> tuple[int, dict]:
    """Elements whose selection (sign mask or top-k drop mask) differs
    between two runs in round r, and per call kind the count — this sees
    the flips that cancel in the payload bits, and a compressed element's
    sign change (0 for an exact zero vs ±1)."""
    a, b = ma.round_calls(r), mb.round_calls(r)
    check(len(a) == len(b), f"round {r}: {len(a)} vs {len(b)} calls")
    n, kinds = 0, {}
    for (ka, xa, da), (kb, xb, db) in zip(a, b):
        check(ka == kb and xa.shape == xb.shape, f"round {r}: the call "
              "streams differ")
        f = int((xa != xb).sum())
        n += f
        key = f"{ka}{'_shared' if da == 1 else '_per_row'}"
        kinds[key] = kinds.get(key, 0) + f
    return n, kinds


def _round1_kernel_check(torch, HC, masks: _Masks) -> dict:
    """Each compress call of the card run's first round against the plain
    version on the SAME device tensors: kept, sign, count and max exact,
    Σ|x| within SUM_RTOL (the F1 check: ProWD's upload is compress on x
    per row at chunks of 1–3 rows, n = 164,134)."""
    worst = 0.0
    for x, thr, out in masks.first:
        want = HC.hybrid_compress_plain(x, thr)
        for i, name in ((0, "kept"), (1, "sign"), (2, "count"), (4, "max")):
            check(torch.equal(out[i], want[i]), f"round 1 compress "
                  f"{tuple(x.shape)}: {name} differs from the plain version "
                  "on the round's own inputs")
        err = (out[3] - want[3]).abs()
        check(bool((err <= SUM_RTOL * want[3].abs() + 1e-30).all()),
              f"round 1 compress {tuple(x.shape)}: sum_abs outside rtol")
        worst = max(worst, float((err / want[3].abs().clamp(min=1e-30))
                                 .max()))
    return {"calls": len(masks.first), "max_rel_sum_err": worst}


def _round1_flips_are_zero_steps(torch, ma: _Masks, mb: _Masks,
                                 w0) -> list:
    """Round 1's compress flips between two runs (F1's kind): at every
    element whose sign differs, one run's input is exactly 0 (sign 0) and
    the other's at most one ulp of the element's round-1 weight ``w0``
    (an SGD step that rounds to zero on one device only). Returns the
    flipped elements' call, row, column and inputs."""
    out = []
    ulp = (torch.nextafter(w0.abs(), torch.tensor(math.inf)) - w0.abs())
    for i, ((xa, _ta, oa), (xb, _tb, ob)) in enumerate(zip(ma.first,
                                                           mb.first)):
        sa, sb = oa[1].cpu(), ob[1].cpu()
        for r, c in torch.nonzero(sa != sb).tolist():
            va, vb = (float((x if x.dim() == 1 else x[r])[c])
                      for x in (xa, xb))
            out.append({"call": i, "row": r, "col": c, "x_a": va, "x_b": vb})
            check(min(abs(va), abs(vb)) == 0.0
                  and max(abs(va), abs(vb)) <= float(ulp[c]),
                  f"round 1 compress flip at row {r}, column {c}: inputs "
                  f"{va} and {vb}, not an exact zero against at most one "
                  f"ulp ({float(ulp[c])}) of its weight")
    return out


def _gate_rounds(torch, what: str, sg, sc, gate_round1: float,
                 gate_later: float, scheme: str) -> list:
    """Round by round, cuda vs cpu: the global vector outside the elements
    whose selection flipped so far (counted from the sign and drop masks,
    over this round and the earlier ones: a flip moves its element of the
    global vector for good) within ``gate_round1`` in round 1 and
    ``gate_later`` after, while the flips so far are at most FLIP_CASCADE
    (past that a threshold-quantized scheme's trajectories have separated:
    the rounds from there on are reported, not gated)."""
    rounds, total = [], 0
    for r, (a, b, ga, gb) in enumerate(zip(
            sg.round_log, sc.round_log, sg.globals_per_round,
            sc.globals_per_round), start=1):
        bits = _bit_flips(scheme, a, b)
        flips, kinds = _mask_flips(sg.masks, sc.masks, r)
        check(flips >= bits, f"{what} round {r}: {flips} mask flips but "
              f"{bits} from the payload bits")
        total += flips
        d = ga - gb
        norm = torch.linalg.vector_norm(gb)
        kept = torch.ones_like(d, dtype=torch.bool)
        kept[torch.topk(d.abs(), min(total, d.numel())).indices] = False
        rel = float(torch.linalg.vector_norm(d[kept]) / norm)
        gate = ((gate_round1 if r == 1 else gate_later)
                if total <= FLIP_CASCADE else None)
        rounds.append({"round": r, "flips": flips, "flips_so_far": total,
                       "flips_by_call": kinds, "payload_bit_flips": bits,
                       "rel_l2_global": rel, "gate": gate,
                       "rel_l2_global_with_flips": float(
                           torch.linalg.vector_norm(d) / norm)})
        if gate is not None:
            check(math.isfinite(rel) and rel <= gate,
                  f"{what} round {r}: global vector rel L2 {rel} > {gate} "
                  f"outside {total} flipped elements")
    return rounds


def _parity_one(torch, SimConfig, Simulator, CaesarConfig, init, scheme):
    """cuda vs cpu for one scheme. Exact over every round: participants,
    plans, sim_time, waiting. The global vector round by round (see
    `_gate_rounds`): round 1 within PARITY_ROUND1_REL_L2, later rounds
    within PARITY_REL_L2 up to FLIP_CASCADE flips. Round 1's compress calls
    on the card are checked against the plain version on their own inputs,
    and round 1's compress flips must be F1's kind."""
    from repro_torch.core import compression as C
    from repro_torch.kernels import hybrid_compress as HC
    runs = {}
    kinds = [("cuda", True), ("cpu", True)]
    if scheme in RERUN_SCHEMES:
        kinds += [("cuda-again", True), ("cuda-sync", False)]
    for dev, pipelined in kinds:
        cfg = SimConfig(dataset="har", scheme=scheme, n_clients=12,
                        participation=0.25, rounds=3, data_scale=0.2, seed=1,
                        eval_every=1, caesar=CaesarConfig(tau=2, b_max=8),
                        device=dev.split("-")[0], pipelined=pipelined)
        sim = _Masks(C).install(Simulator(cfg, init_flat=init))
        runs[dev] = (sim, sim.run())
    (sg, hg), (sc, hc) = runs["cuda"], runs["cpu"]
    for other, what in (("cuda-again", "two same-seed runs on the card"),
                        ("cuda-sync", "pipelined and synchronous runs")):
        if other in runs:
            so, ho = runs[other]
            check(torch.equal(sg.global_flat, so.global_flat)
                  and hg.traffic_bits == ho.traffic_bits,
                  f"{scheme}: {what} differ (the kernels' fixed-order folds "
                  "and deterministic cuDNN should make them bit-identical)")
    for a, b in zip(sg.round_log, sc.round_log):
        check((a["parts"] == b["parts"]).all(),
              f"{scheme}: participants differ")
        for k in ("theta_d", "theta_u", "batch", "taus"):
            check((a[k] == b[k]).all(),
                  f"{scheme} round {a['round']}: plan {k} differs")
    check(hg.sim_time == hc.sim_time, f"{scheme}: sim_time differs")
    check(hg.waiting == hc.waiting, f"{scheme}: waiting differs")
    rounds = _gate_rounds(torch, scheme, sg, sc, PARITY_ROUND1_REL_L2,
                          PARITY_REL_L2, scheme)
    kcheck = _round1_kernel_check(torch, HC, sg.masks)
    rel = _rel_l2(torch, sg.global_flat.cpu(), sc.global_flat)
    tr = max(abs(a - b) / b for a, b in zip(hg.traffic_bits, hc.traffic_bits))
    out = {"rel_l2_global": rel, "per_round": rounds,
           "max_rel_traffic": tr, "acc_cuda": hg.accuracy,
           "acc_cpu": hc.accuracy, "sim_time": hg.sim_time,
           "round1_kernel_vs_plain": kcheck,
           "round1_flips_cuda_vs_cpu": _round1_flips_are_zero_steps(
               torch, sg.masks, sc.masks, init),
           "bit_identical_reruns": sorted(set(runs) - {"cuda", "cpu"})}
    print(f"parity {scheme} cuda vs cpu: " + json.dumps(out))
    if scheme == "caesar":   # the slice-1 check, kept as it was
        check(math.isfinite(rel) and rel <= PARITY_REL_L2,
              f"global vector rel L2 {rel} > {PARITY_REL_L2}")
    return out


def phase_parity(torch, SimConfig, Simulator, CaesarConfig):
    """The fast HAR config on cuda and on cpu from one initial vector, for
    every scheme."""
    from repro_torch.models.paper_models import cnn_har_init
    init = cnn_har_init(torch.Generator().manual_seed(1))
    return {scheme: _parity_one(torch, SimConfig, Simulator, CaesarConfig,
                                init, scheme)
            for scheme in PARITY_SCHEMES}


# the modes of the masked engine, error feedback, the bf16 pool and the
# wire boundary, held cuda vs cpu on phase 5's config: (scheme, SimConfig
# overrides, the round step the recorder wraps)
PARITY_MODES = {
    "masked": ("caesar", {"ragged": False}, "step"),
    "ef_caesar": ("caesar", {"ef": True}, "step_ragged"),
    "ef_prowd": ("prowd", {"ef": True}, "step_ragged"),
    "bf16_sr": ("caesar", {"buffer_dtype": "bfloat16"}, "step_ragged"),
    "loopback": ("caesar", {"wire": "loopback"}, "_wire_round"),
}
# bf16 pool with stochastic rounding, cuda vs cpu after round 1 (outside
# flipped elements): the two devices draw the same rounding noise (a
# counter hash of (seed, row, column)), so only pool values whose f32
# inputs straddle a rounding point differ, by one bf16 ulp. Measured on
# the H100: 9.1e-8 after round 2, 1.3e-7 after round 3 (the pools 1.3e-5
# apart); the bound is ~75x that
BF16_PARITY_REL_L2 = 1e-5


def _mode_cfg(SimConfig, CaesarConfig, scheme, over, dev, pipelined=True,
              **extra):
    over = dict(over)
    ef = over.pop("ef", False)
    return SimConfig(dataset="har", scheme=scheme, n_clients=12,
                     participation=0.25, rounds=3, data_scale=0.2, seed=1,
                     eval_every=1, device=dev, pipelined=pipelined,
                     caesar=CaesarConfig(tau=2, b_max=8,
                                         use_error_feedback=ef),
                     **over, **extra)


def phase_modes_parity(torch, SimConfig, Simulator, CaesarConfig):
    """Each mode of PARITY_MODES on cuda and on cpu from one initial vector:
    participants, plans, sim_time and waiting exact; the global vector
    round by round within PARITY_ROUND1_REL_L2 after round 1 and
    PARITY_REL_L2 later (bf16: BF16_PARITY_REL_L2 after round 1) outside
    the flipped elements; a second same-seed run on the card bit-identical;
    and the zero-fault loopback run bit-identical to the in-process one."""
    from repro_torch.core import compression as C
    from repro_torch.models.paper_models import cnn_har_init
    init = cnn_har_init(torch.Generator().manual_seed(1))
    inproc = Simulator(_mode_cfg(SimConfig, CaesarConfig, "caesar", {},
                                 "cuda"), init_flat=init)
    h_inproc = inproc.run()
    out = {}
    for mode, (scheme, over, step_name) in PARITY_MODES.items():
        runs = {}
        for dev in ("cuda", "cpu", "cuda-again"):
            cfg = _mode_cfg(SimConfig, CaesarConfig, scheme, over,
                            dev.split("-")[0])
            sim = _Masks(C).install(Simulator(cfg, init_flat=init),
                                    step_name)
            runs[dev] = (sim, sim.run())
        (sg, hg), (sc, hc) = runs["cuda"], runs["cpu"]
        so, ho = runs["cuda-again"]
        check(torch.equal(sg.global_flat, so.global_flat)
              and torch.equal(sg.store.pool, so.store.pool)
              and torch.equal(sg.store.ef_pool, so.store.ef_pool)
              and hg.traffic_bits == ho.traffic_bits,
              f"{mode}: two same-seed runs on the card differ")
        for a, b in zip(sg.round_log, sc.round_log):
            check((a["parts"] == b["parts"]).all()
                  and all((a[k] == b[k]).all() for k in
                          ("theta_d", "theta_u", "batch", "taus")),
                  f"{mode} round {a['round']}: participants or plan differ")
        check(hg.sim_time == hc.sim_time and hg.waiting == hc.waiting,
              f"{mode}: sim_time or waiting differs")
        bf16 = over.get("buffer_dtype") == "bfloat16"
        rounds = _gate_rounds(
            torch, mode, sg, sc, PARITY_ROUND1_REL_L2,
            BF16_PARITY_REL_L2 if bf16 else PARITY_REL_L2, scheme)
        res = {"scheme": scheme, "per_round": rounds,
               "rel_l2_global": _rel_l2(torch, sg.global_flat.cpu(),
                                        sc.global_flat),
               "rel_l2_pool": _rel_l2(torch, sg.store.pool.float().cpu(),
                                      sc.store.pool.float()),
               "pool_dtype": str(sg.store.pool.dtype),
               "ef_width": sg.executor.ef_width,
               "ef_norm_cuda": float(sg.store.ef_pool.norm()),
               "acc_cuda": hg.accuracy, "acc_cpu": hc.accuracy,
               "launches": sg.executor.kernel_launches()}
        if mode == "loopback":
            check(torch.equal(sg.global_flat, inproc.global_flat)
                  and hg.traffic_bits == h_inproc.traffic_bits
                  and hg.sim_time == h_inproc.sim_time
                  and hg.accuracy == h_inproc.accuracy,
                  "zero-fault loopback differs from the in-process run on "
                  "the card")
            res["wire_bits"] = hg.wire_bits
            res["bit_identical_to_inproc"] = True
        out[mode] = res
        print(f"modes parity {mode} cuda vs cpu: " + json.dumps(res))
    return out


# the dense HAR point in three modes: (name, SimConfig overrides)
PATH_MODES = (("ragged_f32", {}), ("masked_f32", {"ragged": False}),
              ("ragged_ef_bf16", {"buffer_dtype": "bfloat16", "ef": True}))
PATH_ROUNDS = 3                  # the first cold, then 2 warm


def _dense_cfg(SimConfig, CaesarConfig, rounds, over):
    over = dict(over)
    ef = over.pop("ef", False)
    return SimConfig(dataset="har", n_clients=1000, participation=0.5,
                     data_scale=1.0, rounds=rounds, eval_every=rounds,
                     caesar=CaesarConfig(tau=5, b_max=32,
                                         use_error_feedback=ef),
                     device="cuda", **over)


def phase_modes_path(torch, K, SimConfig, Simulator, CaesarConfig):
    """The dense HAR point (cnn_har, 1000 clients, P = 500, τ 5, b_max 32)
    for PATH_ROUNDS rounds in each of PATH_MODES, the counters zeroed just
    before and read just after (each kernel's launches must equal
    ``kernel_launches()``, and fall on the rungs phase 3 checked): round
    walls and peak device memory; then one round on a fresh simulator, run
    unprofiled for its wall and again (`Simulator.reset`, the same round)
    under the profiler for its device time and busy share."""
    out = {}
    for name, over in PATH_MODES:
        sim = Simulator(_dense_cfg(SimConfig, CaesarConfig, PATH_ROUNDS,
                                   over))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        hist = sim.run()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        by_rows = K.launch_counts_by_rows()
        expect = sim.executor.kernel_launches()
        for k, want in expect.items():
            check(counts[k] == want and want > 0, f"modes path {name}: {k} "
                  f"launched {counts[k]} times, the steps imply {want}")
        _check_rows(f"modes path {name}", counts, by_rows, RUNGS)
        check(bool(torch.isfinite(sim.global_flat).all()),
              f"modes path {name}: non-finite global vector")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del sim
        torch.cuda.empty_cache()
        one = Simulator(_dense_cfg(SimConfig, CaesarConfig, 1, over))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        one.reset()
        kernels, dev_s, win = _profile_kernels(
            torch, one.run, f"profile_modes_{name}.txt")
        warm = hist.wall_per_round[1:]
        out[name] = {"wall_per_round_s": hist.wall_per_round,
                     "warm_median_wall_s": sorted(warm)[len(warm) // 2],
                     "profiled_round_unprofiled_wall_s": wall,
                     "profiled_round_wall_s": win["profiled_run_s"],
                     "device_kernel_s": dev_s,
                     "device_busy_s": win["busy_s"],
                     "device_busy_share": _busy_share(win["busy_s"], wall),
                     "launches": counts, "launches_by_rows": by_rows,
                     "expected": expect,
                     "chunk": one.executor.chunk,
                     "pool_dtype": str(one.store.pool.dtype),
                     "peak_mem_gb": peak, "accuracy": hist.accuracy,
                     "top_kernels": [{"name": ev.key[:90],
                                      "ms": ev.self_device_time_total / 1e3,
                                      "launches": ev.count}
                                     for ev in kernels[:8]]}
        print(f"modes path {name}: " + json.dumps(out[name]))
        del one
        torch.cuda.empty_cache()
    return out


# the wire boundary at full width: ResNet-18 (width 64) on cifar10, Caesar
# with error feedback, a bf16 pool, the loopback wire, trimmed-mean
# aggregation and faults; then the same config with the plain mean, and
# clean, for fig11's robustness gate (benchmarks/fig11_faults.py:57,75-77)
WIRE_FAULTS = dict(dropout_rate=0.1, corrupt_rate=0.05, byzantine_frac=0.1,
                   attack="sign_flip", attack_scale=10.0)
WIRE_RUNS = (("trimmed_mean", "trimmed_mean", True),
             ("mean_attacked", "mean", True), ("clean", "mean", False))
MEAN_DEVIATION_MIN = 1.0
ROBUST_DEVIATION_MAX = 0.8
ROBUST_ACC_TOL = 0.02


def _wire_cfg(SimConfig, CaesarConfig, aggregation, faults):
    from repro_torch.fl.faults import FaultConfig
    base = _schemes_cfg(SimConfig, CaesarConfig, "caesar")
    return dataclasses.replace(
        base, caesar=CaesarConfig(tau=10, b_max=32, use_error_feedback=True),
        buffer_dtype="bfloat16", wire="loopback", aggregation=aggregation,
        faults=FaultConfig(**WIRE_FAULTS) if faults else FaultConfig())


def phase_wire_path(torch, K, SimConfig, Simulator, CaesarConfig, twins):
    """WIRE_RUNS through the port's entry points, each for SCHEMES_ROUNDS
    rounds: round walls, the serialized bytes against the exact payload
    model (Σ payload_nbytes(n, k) over every transmission, a CRC retry
    twice — they must be equal), the Eq.-7 upload bits beside them, fault
    counts per status, peak device memory, launches against
    ``kernel_launches()``. The three final global vectors: the attacked
    mean must deviate from the clean run more than the trimmed mean, which
    keeps the clean accuracy; then fig11's robustness gate at its own
    config (`_fig11_gate`). The trimmed-mean run's final global vector
    and History go to ``twins["wire"]``."""
    import numpy as np

    from repro_torch.fl import faults as F
    from repro_torch.fl import wire as W
    out, finals = {}, {}
    for name, agg, faulty in WIRE_RUNS:
        sim = Simulator(_wire_cfg(SimConfig, CaesarConfig, agg, faulty))
        check(sim.n_params == RESNET_PARAMS, "wire path: not ResNet-18 w64")
        nnz = []
        deferred = sim.executor.step_ragged_deferred

        def rec(*a, _step=deferred, _nnz=nnz, **k):
            res = _step(*a, **k)
            n = np.zeros(len(a[2]), np.int64)
            for pos_c, slots, _c, ups in res[0]:
                n[pos_c] = (ups != 0).sum(1).cpu().numpy()[slots]
            _nnz.append(n)
            return res
        sim.executor.step_ragged_deferred = rec
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        hist = sim.run(log=print)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        by_rows = K.launch_counts_by_rows()
        expect = sim.executor.kernel_launches()
        for k, want in expect.items():
            check(counts[k] == want and want > 0, f"wire path {name}: {k} "
                  f"launched {counts[k]} times, the steps imply {want}")
        _check_rows(f"wire path {name}", counts, by_rows, RESNET_RUNGS)
        modelled, measured, status = [], [], {}
        for e, n in zip(sim.fault_log, nnz):
            sent = e["status"] != F.DROP
            modelled.append(int(sum(
                W.payload_nbytes(sim.n_params, int(k))
                * (1 + int(c)) for k, c, s in zip(n, e["corrupt_first"],
                                                  sent) if s)))
            measured.append(int(e["wire_bytes"]))
            for code, label in ((F.OK, "ok"), (F.DROP, "drop"),
                                (F.LATE, "late"),
                                (F.CORRUPT_DROP, "corrupt_drop")):
                status[label] = status.get(label, 0) + int(
                    (e["status"] == code).sum())
            status["byzantine"] = status.get("byzantine", 0) + int(
                e["byz"].sum())
            status["corrupt_first"] = status.get("corrupt_first", 0) + int(
                e["corrupt_first"].sum())
            status["crc_dropped"] = status.get("crc_dropped", 0) + int(
                e["n_crc_dropped"])
        check(modelled == measured, f"wire path {name}: serialized bytes "
              f"{measured} != payload model {modelled}")
        check(bool(torch.isfinite(sim.global_flat).all()),
              f"wire path {name}: non-finite global vector")
        check(sim.store.pool.dtype == torch.bfloat16
              and sim.store.ef_pool.shape[1] == sim.n_params,
              f"wire path {name}: pool is not bf16 with an EF pool")
        up_bits = [float(e["up_bits"].sum()) for e in sim.round_log]
        out[name] = {
            "aggregation": agg, "faults": WIRE_FAULTS if faulty else None,
            "wall_per_round_s": hist.wall_per_round,
            "wire_bytes_per_round": measured,
            "payload_model_bytes_per_round": modelled,
            "eq7_upload_bits_per_round": up_bits,
            "fault_counts": status, "accuracy": hist.accuracy,
            "launches": counts, "launches_by_rows": by_rows,
            "chunk": sim.executor.chunk, "store": sim.store.telemetry(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "memory_budget_gb": {
                "bf16_pool": sim.store.capacity * sim.n_params * 2 / 1e9,
                "ef_pool": sim.store.capacity * sim.n_params * 4 / 1e9,
                "uploads_per_chunk_host": sim.executor.chunk
                * sim.n_params * 4 / 1e9}}
        print(f"wire path {name}: " + json.dumps(out[name]))
        finals[name] = (sim.global_flat.detach().cpu(), hist.accuracy[-1],
                        sim.flat0)
        if name == "trimmed_mean":
            twins["wire"] = (finals[name][0], hist)
        del sim
        torch.cuda.empty_cache()
    g_clean, acc_clean, g0 = finals["clean"]
    norm = float(torch.linalg.vector_norm(g_clean))
    moved = float(torch.linalg.vector_norm(g_clean - g0))
    dev = {k: float(torch.linalg.vector_norm(finals[k][0] - g_clean))
           for k in ("mean_attacked", "trimmed_mean")}
    gate = {"mean_deviation": dev["mean_attacked"] / norm,
            "trimmed_deviation": dev["trimmed_mean"] / norm,
            "mean_deviation_of_clean_step": dev["mean_attacked"] / moved,
            "trimmed_deviation_of_clean_step": dev["trimmed_mean"] / moved,
            "clean_acc": acc_clean,
            "trimmed_acc": finals["trimmed_mean"][1],
            "mean_attacked_acc": finals["mean_attacked"][1]}
    out["resnet18_deviations"] = gate
    print("wire path deviations (resnet18): " + json.dumps(gate))
    # fig11's bounds are relative to the fault-free model's norm, which 3
    # rounds of ResNet-18 barely move (the attacked mean 0.165 of it on
    # the H100); here the attack must move the plain mean further than
    # the trimmed mean, which must keep the fault-free accuracy (fig11's
    # gate runs at its own config below)
    check(gate["trimmed_deviation"] < gate["mean_deviation"]
          and gate["trimmed_acc"] >= acc_clean - ROBUST_ACC_TOL,
          f"wire path: trimmed mean no more robust than the mean: {gate}")
    out["fig11_gate"] = _fig11_gate(torch, SimConfig, Simulator,
                                    CaesarConfig)
    return out


def _fig11_gate(torch, SimConfig, Simulator, CaesarConfig) -> dict:
    """fig11's robustness gate (benchmarks/fig11_faults.py:424-451) on the
    card, at its own config (oppo_ts with 64 features → lr, 12 clients,
    participation 0.5, τ 2, b_max 8, EF on, 8 rounds, the loopback wire):
    a 10% sign-flip adversary moves the plain mean's global vector at least
    MEAN_DEVIATION_MIN of the fault-free one's norm, while the trimmed mean
    stays within ROBUST_DEVIATION_MAX and within ROBUST_ACC_TOL of the
    fault-free accuracy."""
    from repro_torch.fl.faults import FaultConfig

    def final(aggregation, byz):
        cfg = SimConfig(dataset="oppo_ts", rounds=8, n_clients=12,
                        data_scale=0.01, eval_every=4, participation=0.5,
                        dataset_kwargs={"n_features": 64}, device="cuda",
                        caesar=CaesarConfig(tau=2, b_max=8,
                                            use_error_feedback=True),
                        wire="loopback", aggregation=aggregation,
                        faults=FaultConfig(byzantine_frac=byz,
                                           attack="sign_flip",
                                           attack_scale=10.0))
        sim = Simulator(cfg)
        h = sim.run()
        return sim.global_flat.detach().cpu(), h.accuracy[-1]

    g_clean, acc_clean = final("mean", 0.0)
    g_mean, acc_mean = final("mean", 0.1)
    g_trim, acc_trim = final("trimmed_mean", 0.1)
    norm = float(torch.linalg.vector_norm(g_clean))
    gate = {"mean_deviation": float(torch.linalg.vector_norm(
                g_mean - g_clean)) / norm,
            "trimmed_deviation": float(torch.linalg.vector_norm(
                g_trim - g_clean)) / norm,
            "clean_acc": acc_clean, "mean_attacked_acc": acc_mean,
            "trimmed_acc": acc_trim}
    print("fig11 robustness gate (card): " + json.dumps(gate))
    check(gate["mean_deviation"] >= MEAN_DEVIATION_MIN
          and gate["trimmed_deviation"] <= ROBUST_DEVIATION_MAX
          and acc_trim >= acc_clean - ROBUST_ACC_TOL,
          f"fig11's robustness gate fails on the card: {gate}")
    return gate


def _check_rows(what: str, counts: dict, by_rows: dict, rungs) -> None:
    """A path's launches by batch rows add up to its launches and fall on
    the rungs that phase 3 held against the plain versions at its n."""
    for name, per in by_rows.items():
        check(sum(per.values()) == counts[name] and set(per) <= set(rungs),
              f"{what}: {name}'s launches by rows {per} do not add up to "
              f"{counts[name]} over the rungs {rungs} checked in phase 3")


def _main_cfg(SimConfig, CaesarConfig):
    return SimConfig(dataset="har", n_clients=1000, participation=0.5,
                     data_scale=1.0, rounds=4,
                     caesar=CaesarConfig(tau=5, b_max=32), device="cuda")


def phase_main(torch, K, SimConfig, Simulator, CaesarConfig, twins):
    """The dense HAR point through the port's entry points; its final
    global vector (on the host) and History go to ``twins["dense"]``."""
    cfg = _main_cfg(SimConfig, CaesarConfig)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    hist = sim.run(log=print)
    counts = K.launch_counts()
    by_rows = K.launch_counts_by_rows()
    tel = sim.executor.telemetry()
    rounds = tel["rounds"]
    expect = sim.executor.kernel_launches()
    print("main path launches: " + json.dumps(counts) + " expected "
          + json.dumps(expect))
    print("main path launches by chunk rows: " + json.dumps(by_rows))
    check(rounds == cfg.rounds, f"ran {rounds} rounds, want {cfg.rounds}")
    for name, want in expect.items():
        check(counts[name] > 0, f"{name} never launched on the main path")
        check(counts[name] == want, f"{name}: {counts[name]} launches, "
              f"tier layout implies {want}")
    _check_rows("main path", counts, by_rows, RUNGS)
    check(sim.store.pool.is_cuda and sim.global_flat.is_cuda,
          "pool/global vector not on the card")
    check(bool(torch.isfinite(sim.global_flat).all()), "non-finite global")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in hist.accuracy),
          "bad accuracy")
    out = {"setup_s": setup_s, "wall_per_round_s": hist.wall_per_round,
           "accuracy": hist.accuracy, "traffic_bits": hist.traffic_bits,
           "sim_time": hist.sim_time, "telemetry": tel,
           "launches_by_rows": by_rows,
           "store": sim.store.telemetry(), "chunk": sim.executor.chunk,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    print("main path: " + json.dumps(out))
    twins["dense"] = (sim.global_flat.detach().cpu(), hist)
    return cfg, counts, by_rows, out


def _profile_kernels(torch, fn, table_name):
    """CUDA events of one call of ``fn``, sorted by device time, their
    total device seconds, and the window (`_profile_once`); the table goes
    to OUT_DIR/<table_name>."""
    window = {}
    kernels = _cuda_events(torch, fn, table_name, window)
    return (kernels, sum(ev.self_device_time_total for ev in kernels) / 1e6,
            window)


def _busy_share(busy_s: float, wall_s: float):
    """The share of an unprofiled wall the card was busy: a profiled
    rerun's union of device intervals over that wall. None where it comes
    out above 1: the profiled rerun's device work does not fit in the
    unprofiled wall, so it is not the same work and no share is given."""
    share = busy_s / wall_s
    return share if share <= 1.0 else None


def phase_profile(torch, cfg, Simulator, wall_per_round):
    """Where the dense point's round time goes: a 1-round rerun under
    torch.profiler. Device time is summed over CUDA kernel events only;
    the busy share is the union of their intervals over the UNPROFILED
    median wall of the main run's rounds after the first."""
    sim = Simulator(dataclasses.replace(cfg, rounds=1))
    kernels, per_round, win = _profile_kernels(torch, sim.run,
                                               "profile_dense_har.txt")
    warm = sorted(wall_per_round[1:] or wall_per_round)
    wall = warm[len(warm) // 2]
    out = {"device_kernel_s_per_round": per_round,
           "device_busy_s_per_round": win["busy_s"],
           "profiled_round_wall_s": win["profiled_run_s"],
           "median_round_wall_s": wall,
           "device_busy_share": _busy_share(win["busy_s"], wall),
           "top_kernels": [{"name": ev.key[:90],
                            "ms_per_round": ev.self_device_time_total / 1e3,
                            "launches_per_round": ev.count}
                           for ev in kernels[:15]]}
    print("profile (dense HAR, per round): " + json.dumps(out))
    return out


# the sharded round engine: 4 ranks of a gloo group on one card (NCCL
# refuses two ranks on one card), each holding its own pool segment
SHARD_WORLD = 4
SHARD_TIMEOUT_S = 300.0          # a rank that falls out of step fails
SHARD_DEVS = ("cuda", "cpu")     # (c): the card against the plain versions
SHARD_MODES = (("ragged", "step_ragged", {}),
               ("masked", "step", {"ragged": False}))
HISTORY_KEYS = ("rounds", "sim_time", "traffic_bits", "accuracy", "waiting",
                "waiting_per_round")


def _history(h) -> dict:
    """A History's metric series (not its walls: each rank's own clock)."""
    return {k: list(getattr(h, k)) for k in HISTORY_KEYS}


def _parity_cfg(SimConfig, CaesarConfig, dev, **over):
    """Phase 5's small HAR config (12 clients, τ 2, b_max 8, 3 rounds)."""
    return SimConfig(dataset="har", scheme="caesar", n_clients=12,
                     participation=0.25, rounds=3, data_scale=0.2, seed=1,
                     eval_every=1, caesar=CaesarConfig(tau=2, b_max=8),
                     device=dev, **over)


def _shard_rank(rank, world, store, out_dir, main_cfg, init):
    """One rank of phase 6f's world of 4 on cuda:0: (b) the dense HAR point
    at full width, sharded, with its launch counts; (c) phase 5's config
    on each of `SHARD_DEVS`, ragged and masked, with every
    compress and top-k selection recorded (`_Masks`). Results go to
    out_dir/rank<r>.pt."""
    import warnings

    import torch
    import torch.distributed as dist

    import repro_torch.kernels as K
    from repro_torch.core import compression as C
    from repro_torch.core.caesar import CaesarConfig
    from repro_torch.fl.simulation import SimConfig, Simulator
    from repro_torch.launch import mesh as MESH
    warnings.simplefilter("ignore", UserWarning)   # the cohort adjustment
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=SHARD_TIMEOUT_S / 2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sim = Simulator(dataclasses.replace(main_cfg, sharded=True,
                                        multi_host=True))
    K.reset_launch_counts()
    hist = sim.run()
    counts, by_rows = K.launch_counts(), K.launch_counts_by_rows()
    st = sim.store
    out = {"b": {
        "history": _history(hist), "wall_per_round_s": hist.wall_per_round,
        "launches": counts, "launches_by_rows": by_rows,
        "expect": sim.executor.kernel_launches(),
        "pool_device": str(st.pool.device), "pool_rows": st.pool.shape[0],
        "cap_per_shard": st.cap_per_shard, "row0": st.row0,
        "n_dev": sim.n_dev, "p_shard": sim.executor.p_shard,
        "chunk": sim.executor.chunk,
        "global": sim.global_flat.detach().cpu(),
        "round_log": sim.round_log,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}}
    del sim, st
    torch.cuda.empty_cache()
    for mode, step, over in SHARD_MODES:
        for i, dev in enumerate(SHARD_DEVS):
            s = _Masks(C).install(Simulator(
                _parity_cfg(SimConfig, CaesarConfig, dev, sharded=True,
                            **over), init_flat=init), step)
            h = s.run()
            out[f"c_{mode}_{i}"] = {
                "history": _history(h), "round_log": s.round_log,
                "globals_per_round": s.globals_per_round,
                "calls": s.masks.calls, "ends": s.masks.ends,
                "n_dev": s.n_dev}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


class _RankMasks:
    """The masks of every rank's run as one `_Masks`: round r's calls are
    rank 0's calls of round r, then rank 1's, … (each rank compresses its
    own shard's rows)."""

    def __init__(self, ranks: list):
        self.ranks = ranks

    def round_calls(self, r: int) -> list:
        out = []
        for calls, ends in self.ranks:
            out += calls[(ends[r - 2] if r > 1 else 0):ends[r - 1]]
        return out


def _same_logs_all(what, logs) -> None:
    import numpy as np
    for r, log in enumerate(logs[1:], 1):
        check(len(log) == len(logs[0]), f"{what}: rank {r}'s round_log "
              "length differs")
        for a, b in zip(log, logs[0]):
            for k in a:
                check(bool(np.all(np.asarray(a[k]) == np.asarray(b[k]))),
                      f"{what}: rank {r}'s round_log {k} differs from "
                      "rank 0's")


def phase_sharded(torch, K, SimConfig, Simulator, CaesarConfig, twins,
                  main_counts, smi):
    """(a) The dense HAR point sharded in a world of 1 (an NCCL group of
    one rank in this process; a world of 1 makes no collective, so this
    checks the layout's world-of-1 path, not NCCL): global vector and History bit-identical to phase 6's
    unsharded run, launches equal. (b) The same point on 4 gloo ranks on
    cuda:0: every rank's History and round_log the same, its pool a
    segment of exactly cap_per_shard rows on cuda:0, its launches those
    `kernel_launches` implies and on the rungs phase 3 held against the
    plain versions, the global vector finite and the same on every rank.
    (c) Phase 5's config on the 4 ranks, cuda against cpu, ragged and
    masked: participants, plans, sim_time and waiting exact; the global
    vector gated round by round as phase 5 (`_gate_rounds`), the flips
    counted over every rank's selections."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as MESH
    work = os.path.join(ROOT, "build", "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    # (a) a world of 1
    main_cfg = _main_cfg(SimConfig, CaesarConfig)
    MESH.init_distributed(f"file://{work}/pg_world1", 1, 0, backend="nccl")
    try:
        cfg = dataclasses.replace(main_cfg, sharded=True)
        sim = Simulator(cfg)
        check(sim.n_dev == 1 and sim.layout.group is not None,
              "the world of 1 is not a process group")
        K.reset_launch_counts()
        hist = sim.run()
        counts = K.launch_counts()
    finally:
        dist.destroy_process_group()
    g0, h0 = twins["dense"]
    check(torch.equal(sim.global_flat.cpu(), g0),
          "sharded world of 1: global vector differs from the unsharded run")
    check(_history(hist) == _history(h0),
          "sharded world of 1: History differs from the unsharded run")
    check(counts == main_counts, f"sharded world of 1: launches {counts} "
          f"!= the unsharded run's {main_counts}")
    out["world1"] = {"bit_identical": True, "launches": counts,
                     "wall_per_round_s": hist.wall_per_round}
    del sim
    torch.cuda.empty_cache()

    # (b) and (c): a world of 4 gloo ranks on cuda:0
    from repro_torch.models.paper_models import cnn_har_init
    init = cnn_har_init(torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    MESH.spawn(_shard_rank, SHARD_WORLD,
               (SHARD_WORLD, f"{work}/pg_world4", work, main_cfg, init),
               timeout_s=SHARD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(SHARD_WORLD)]
    b0 = ranks[0]["b"]
    for r, res in enumerate(ranks):
        b = res["b"]
        check(b["history"] == b0["history"],
              f"sharded 4 ranks: rank {r}'s History differs from rank 0's")
        check(torch.equal(b["global"], b0["global"]),
              f"sharded 4 ranks: rank {r}'s global vector differs")
        check((b["n_dev"], b["pool_device"]) == (SHARD_WORLD, "cuda:0")
              and b["pool_rows"] == b["cap_per_shard"]
              and b["row0"] == r * b["cap_per_shard"],
              f"sharded 4 ranks: rank {r}'s pool is not its segment of "
              f"{b['cap_per_shard']} rows on cuda:0: {b['pool_rows']} "
              f"rows from slot {b['row0']} on {b['pool_device']}")
        for name, want in b["expect"].items():
            check(b["launches"][name] == want > 0,
                  f"sharded 4 ranks: rank {r} launched {name} "
                  f"{b['launches'][name]} times, the layout implies {want}")
        _check_rows(f"sharded rank {r}", b["launches"],
                    b["launches_by_rows"], RUNGS)
    _same_logs_all("sharded 4 ranks", [res["b"]["round_log"]
                                       for res in ranks])
    check(bool(torch.isfinite(b0["global"]).all()),
          "sharded 4 ranks: non-finite global vector")
    walls = [res["b"]["wall_per_round_s"] for res in ranks]
    out["world4_dense"] = {
        "card": smi, "note": "4 ranks share one card: these walls say "
        "nothing of scaling across cards",
        "spawn_s": spawn_s, "p_shard": b0["p_shard"], "chunk": b0["chunk"],
        "cap_per_shard": b0["cap_per_shard"],
        "wall_per_round_s_by_rank": walls,
        "wall_per_round_s_max": [max(w) for w in zip(*walls)],
        "launches_per_rank": b0["launches"],
        "launches_by_rows_rank0": b0["launches_by_rows"],
        "accuracy": b0["history"]["accuracy"],
        "traffic_bits": b0["history"]["traffic_bits"],
        "sim_time": b0["history"]["sim_time"],
        "peak_mem_gb_by_rank": [res["b"]["peak_mem_gb"] for res in ranks]}
    print(f"sharded 4 ranks on one card ({smi}): wall per round (max over "
          f"ranks) {out['world4_dense']['wall_per_round_s_max']} s — 4 ranks "
          "share one card, so this says nothing of scaling across cards")

    # (c) cuda against cpu on the 4 ranks
    for mode, _step, _over in SHARD_MODES:
        runs = {}
        for i, dev in enumerate(SHARD_DEVS):
            per = [res[f"c_{mode}_{i}"] for res in ranks]
            check(all(p["n_dev"] == SHARD_WORLD for p in per),
                  f"sharded {mode} {dev}: not a world of {SHARD_WORLD}")
            check(all(p["history"] == per[0]["history"] for p in per),
                  f"sharded {mode} {dev}: the ranks' Histories differ")
            _same_logs_all(f"sharded {mode} {dev}",
                           [p["round_log"] for p in per])
            runs[i] = types.SimpleNamespace(
                round_log=per[0]["round_log"],
                globals_per_round=per[0]["globals_per_round"],
                masks=_RankMasks([(p["calls"], p["ends"]) for p in per]),
                history=per[0]["history"])
        sg, sc = runs[0], runs[1]
        for a, b in zip(sg.round_log, sc.round_log):
            check((a["parts"] == b["parts"]).all(),
                  f"sharded {mode}: participants differ cuda vs cpu")
            for k in ("theta_d", "theta_u", "batch", "taus"):
                check((a[k] == b[k]).all(), f"sharded {mode} round "
                      f"{a['round']}: plan {k} differs cuda vs cpu")
        check(sg.history["sim_time"] == sc.history["sim_time"]
              and sg.history["waiting"] == sc.history["waiting"],
              f"sharded {mode}: sim_time or waiting differ cuda vs cpu")
        rounds = _gate_rounds(torch, f"sharded {mode}", sg, sc,
                              PARITY_ROUND1_REL_L2, PARITY_REL_L2, "caesar")
        out[f"world4_parity_{mode}"] = {
            "per_round": rounds, "acc_cuda": sg.history["accuracy"],
            "acc_cpu": sc.history["accuracy"]}
    shutil.rmtree(work, ignore_errors=True)
    print("sharded: " + json.dumps(out))
    return out


# the schemes path: the paper's ResNet-18 at its published width on
# cifar10, each scheme for SCHEMES_ROUNDS rounds (the reference harness's
# cifar10 τ and b_max, benchmarks/common.py; the SimConfig default cohort)
SCHEMES_PATH = ("fedavg", "fic", "cac", "flexcom", "prowd", "pyramidfl",
                "caesar")
SCHEMES_ROUNDS = 3
RESNET_PARAMS = 11164362         # resnet18 at width 64, 10 classes
CIFAR_PARAMS = 699066            # cnn_cifar (resnet18 at width 16)
SCHEMES_PROFILED = ("caesar", "prowd")


def _schemes_cfg(SimConfig, CaesarConfig, scheme, rounds=SCHEMES_ROUNDS):
    return SimConfig(dataset="cifar10", model="resnet18", scheme=scheme,
                     n_clients=100, participation=0.1, data_scale=0.2,
                     rounds=rounds, eval_every=rounds,
                     caesar=CaesarConfig(tau=10, b_max=32), device="cuda")


def phase_schemes(torch, K, SimConfig, Simulator, CaesarConfig):
    """Every scheme through the port's entry points on ResNet-18 at width
    64, the launch counters zeroed just before each run and read just
    after: each must equal what the scheme's tier layout implies."""
    out = {}
    for scheme in SCHEMES_PATH:
        cfg = _schemes_cfg(SimConfig, CaesarConfig, scheme)
        t0 = time.perf_counter()
        sim = Simulator(cfg)
        setup_s = time.perf_counter() - t0
        check(sim.n_params == RESNET_PARAMS, f"resnet18 has {sim.n_params} "
              f"parameters, want {RESNET_PARAMS}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        hist = sim.run(log=print)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        by_rows = K.launch_counts_by_rows()
        expect = sim.executor.kernel_launches()
        tel = sim.executor.telemetry()
        print(f"schemes path {scheme} launches: " + json.dumps(counts)
              + " expected " + json.dumps(expect))
        check(tel["rounds"] == cfg.rounds, f"{scheme}: ran {tel['rounds']} "
              f"rounds, want {cfg.rounds}")
        for name, want in expect.items():
            check(counts[name] == want, f"{scheme}: {name} launched "
                  f"{counts[name]} times, tier layout implies {want}")
        _check_rows(f"schemes path {scheme}", counts, by_rows, RESNET_RUNGS)
        check(counts["magnitude_histogram"] > 0
              and counts["hybrid_compress"] > 0, f"{scheme}: a compression "
              "kernel never launched")
        check((counts["recover"] > 0) == (scheme == "caesar"),
              f"{scheme}: recover launched {counts['recover']} times")
        check(counts["decode_attention"] == 0, "decode ran on the FL path")
        check(sim.store.pool.is_cuda and sim.global_flat.is_cuda,
              f"{scheme}: pool/global vector not on the card")
        check(bool(torch.isfinite(sim.global_flat).all()),
              f"{scheme}: non-finite global vector")
        check(all(math.isfinite(a) and 0.0 <= a <= 1.0
                  for a in hist.accuracy), f"{scheme}: bad accuracy")
        traffic = [float(e["down_bits"].sum() + e["up_bits"].sum())
                   for e in sim.round_log]
        out[scheme] = {
            "setup_s": setup_s, "wall_per_round_s": hist.wall_per_round,
            "traffic_bits_per_round": traffic, "sim_time": hist.sim_time,
            "accuracy": hist.accuracy, "launches": counts,
            "launches_by_rows": by_rows, "telemetry": tel,
            "store": sim.store.telemetry(), "chunk": sim.executor.chunk,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        print(f"schemes path {scheme}: " + json.dumps(out[scheme]))
        del sim
        torch.cuda.empty_cache()
    return out


def phase_schemes_profile(torch, SimConfig, Simulator, CaesarConfig,
                          walls: dict):
    """One round of each scheme in SCHEMES_PROFILED, run twice on one
    simulator (`Simulator.reset` between, so both runs plan and compute
    the same round): unprofiled for its wall, then profiled for device
    time by kernel and the compression kernels' share. The busy share is
    the second's union of device intervals over the first's wall
    (`_busy_share`); the schemes path's median wall of rounds after the
    first is given beside it."""
    out = {}
    for scheme in SCHEMES_PROFILED:
        sim = Simulator(_schemes_cfg(SimConfig, CaesarConfig, scheme,
                                     rounds=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim.reset()
        kernels, per_round, win = _profile_kernels(
            torch, sim.run, f"profile_resnet18_{scheme}.txt")
        warm = sorted(walls[scheme][1:] or walls[scheme])
        ours = {}
        for ev in kernels:
            for name in ("magnitude_histogram_kernel", "hybrid_compress_kernel",
                         "recover_kernel"):
                if name in ev.key:
                    ours[name] = ours.get(name, 0.0) + (
                        ev.self_device_time_total / 1e3)
        out[scheme] = {
            "device_kernel_s_per_round": per_round,
            "device_busy_s_per_round": win["busy_s"],
            "round_wall_s": wall,
            "profiled_round_wall_s": win["profiled_run_s"],
            "schemes_path_median_round_wall_s": warm[len(warm) // 2],
            "device_busy_share": _busy_share(win["busy_s"], wall),
            "compression_kernels_ms": ours,
            "top_kernels": [{"name": ev.key[:90],
                             "ms_per_round": ev.self_device_time_total / 1e3,
                             "launches_per_round": ev.count}
                            for ev in kernels[:15]]}
        print(f"profile (resnet18 {scheme}, per round): "
              + json.dumps(out[scheme]))
        del sim
        torch.cuda.empty_cache()
    return out


def _rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _teacher_forced(torch, M, params, cfg, seq):
    """Logits [steps, B, V] (f32) of decode_step fed seq [B, T] token by
    token, T − 1 steps."""
    b, t = seq.shape
    cache = M.init_cache(cfg, b, t)
    length = torch.zeros(b, dtype=torch.int32, device=seq.device)
    out = []
    for i in range(t - 1):
        logits, cache = M.decode_step(params, cache,
                                      {"tokens": seq[:, i:i + 1]}, length,
                                      cfg)
        out.append(logits.float())
        length = length + 1
    return torch.stack(out)


def phase_serve(torch, K):
    """Qwen1.5-4B at full width through the port's serve entry points."""
    import repro_torch.configs as configs
    from repro_torch.core import rng as RNG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M

    cfg = configs.get(SERVE_ARCH)
    check(cfg.n_layers == 40 and cfg.d_model == 2560 and cfg.vocab == 151936,
          "the serve phase must run the published width")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    prompt = torch.from_numpy(RNG.stream(0, RNG.KIND_DATASET).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to(dev, torch.int32)
    steps = SERVE_PROMPT + SERVE_NEW - 1

    # the serve path, counted
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = M.generate(params, cfg, prompt, SERVE_NEW)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = K.launch_counts()
    want = cfg.n_layers * steps
    print("serve path launches: " + json.dumps(counts) + f" expected "
          f"decode_attention {want}")
    check(counts["decode_attention"] == want,
          f"decode_attention launched {counts['decode_attention']} times, "
          f"want n_layers × steps = {want}")
    check(all(n == 0 for k, n in counts.items() if k != "decode_attention"),
          "a compression kernel launched on the serve path")
    check(tuple(out.shape) == (SERVE_BATCH, SERVE_NEW), "bad output shape")
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of range")

    # warm reruns: latency and throughput (same seed, same tokens)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = M.generate(params, cfg, prompt, SERVE_NEW)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(torch.equal(again, out), "same-seed reruns differ")
    wall = sum(walls) / len(walls)

    # kernel path vs plain path over one teacher-forced sequence
    seq = torch.cat([prompt, out], dim=1)
    via_kernel = _teacher_forced(torch, M, params, cfg, seq)
    M.decode_attention = FA.decode_attention_plain
    try:
        via_plain = _teacher_forced(torch, M, params, cfg, seq)
    finally:
        M.decode_attention = FA.decode_attention
    check(bool(torch.isfinite(via_kernel).all()), "non-finite logits")
    rel = [_rel_l2(torch, a, b) for a, b in zip(via_kernel, via_plain)]
    agree = float((via_kernel.argmax(-1) == via_plain.argmax(-1)).float()
                  .mean())
    # decode vs prefill over the same tokens (last position)
    pre = M.prefill(params, {"tokens": seq[:, :steps]}, cfg)
    rel_pre = _rel_l2(torch, via_kernel[-1], pre)
    plain_pre = _rel_l2(torch, via_plain[-1], pre)

    # device busy share over a window of PROFILE_STEPS decode steps: the
    # same teacher-forced steps unprofiled (wall) and profiled (kernels)
    window = seq[:, :PROFILE_STEPS + 1]
    t0 = time.perf_counter()
    _teacher_forced(torch, M, params, cfg, window)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    kernels, dev_s, win = _profile_kernels(
        torch, lambda: _teacher_forced(torch, M, params, cfg, window),
        "profile_serve.txt")
    dec = _decode_events(kernels, cfg.n_layers * PROFILE_STEPS)
    long_res = _long_cache_window(torch, M, FA, params, cfg)
    res = {
        "arch": cfg.name, "n_params": n_params, "init_s": init_s,
        "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
        "new_tokens": SERVE_NEW, "decode_steps": steps,
        "cold_wall_s": cold_s, "warm_walls_s": walls,
        "ms_per_step": wall / steps * 1e3,
        "tokens_per_s": SERVE_BATCH * SERVE_NEW / wall,
        "decode_tokens_per_s": SERVE_BATCH * steps / wall,
        "profile_steps": PROFILE_STEPS, "window_wall_s": window_s,
        "device_s_per_step": dev_s / PROFILE_STEPS,
        "device_busy_share": _busy_share(win["busy_s"], window_s),
        "decode_kernel_ms_per_launch": dec["ms_per_launch"],
        "decode_kernel_share": dec["ms"] / (dev_s * 1e3),
        "kernel_vs_plain_rel_l2_max": max(rel),
        "kernel_vs_plain_rel_l2_median": sorted(rel)[len(rel) // 2],
        "kernel_vs_plain_rel_l2_per_step": rel,
        "kernel_vs_plain_argmax_agree": agree,
        "decode_vs_prefill_rel_l2": rel_pre,
        "plain_decode_vs_prefill_rel_l2": plain_pre,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "sample": out[0, :16].tolist(),
        "top_kernels": [{"name": ev.key[:90],
                         "ms": ev.self_device_time_total / 1e3,
                         "launches": ev.count} for ev in kernels[:12]],
        "long_cache": long_res,
    }
    print("serve path: " + json.dumps(res))
    check(max(rel) <= SERVE_REL_L2, f"kernel vs plain logits rel L2 "
          f"{max(rel):.3g} > {SERVE_REL_L2}")
    check(agree >= SERVE_ARGMAX_AGREE, f"kernel vs plain greedy tokens "
          f"agree on {agree:.3f} < {SERVE_ARGMAX_AGREE} of steps")
    check(rel_pre <= SERVE_REL_L2, f"decode vs prefill logits rel L2 "
          f"{rel_pre:.3g} > {SERVE_REL_L2}")
    check(long_res["kernel_vs_plain_rel_l2_last_step"] <= SERVE_REL_L2,
          f"long cache: kernel vs plain logits rel L2 "
          f"{long_res['kernel_vs_plain_rel_l2_last_step']:.3g} > "
          f"{SERVE_REL_L2}")
    return counts, res


def _decode_events(kernels, want_launches: int) -> dict:
    """The decode kernel's profiler events in a serve window of
    want_launches wrapper calls: one kernel name, no more events than
    calls, and at least PROFILE_KEEP of them (the profiler's buffers drop
    a few of a window's ~24k kernel events: 394 of 400 in one H100 run);
    its ms and ms per launch."""
    dec = [ev for ev in kernels if "decode_kernel" in ev.key]
    check(len(dec) == 1 and PROFILE_KEEP * want_launches <= dec[0].count
          <= want_launches,
          "serve window: decode kernels "
          f"{[(e.key[:60], e.count) for e in dec]}, want one kernel "
          f"launched {want_launches} times")
    ms = dec[0].self_device_time_total / 1e3
    return {"ms": ms * want_launches / dec[0].count,
            "ms_per_launch": ms / dec[0].count,
            "profiled_launches": dec[0].count}


def _long_cache_window(torch, M, FA, params, cfg):
    """LONG_STEPS teacher-forced decode steps from length LONG_START into a
    LONG_CACHE-position cache (made with init_cache, filled layer by layer
    from a seeded generator in the model dtype): wall ms per step (warm,
    host clock ending in a sync), device time per step and the decode
    kernel's share and per-launch time (profiled rerun of the same steps),
    and the kernel path's vs the plain path's logits at the last step (both
    from the same cache: each rewrites the last position with its own K/V,
    and every earlier position is the same)."""
    dev = torch.device("cuda")
    b = SERVE_BATCH
    cache = M.init_cache(cfg, b, LONG_CACHE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for name in ("k", "v"):
        for layer in cache["layers"][name]:
            layer.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab, (b, LONG_STEPS), generator=gen,
                           device=dev, dtype=torch.int32)

    def steps(n):
        length = torch.full((b,), LONG_START, dtype=torch.int32, device=dev)
        logits = None
        for i in range(n):
            logits, _ = M.decode_step(params, cache,
                                      {"tokens": tokens[:, i:i + 1]}, length,
                                      cfg)
            length = length + 1
        return logits

    steps(2)                                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(LONG_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels, dev_s, win = _profile_kernels(
        torch, lambda: steps(LONG_STEPS), "profile_serve_long.txt")
    dec = _decode_events(kernels, cfg.n_layers * LONG_STEPS)
    # last step: kernel path, then plain path, from the same cache
    steps(LONG_STEPS - 1)
    length = torch.full((b,), LONG_START + LONG_STEPS - 1, dtype=torch.int32,
                        device=dev)
    last = {"tokens": tokens[:, -1:]}
    via_kernel = M.decode_step(params, cache, last, length, cfg)[0].float()
    M.decode_attention = FA.decode_attention_plain
    try:
        via_plain = M.decode_step(params, cache, last, length, cfg)[0].float()
    finally:
        M.decode_attention = FA.decode_attention
    check(bool(torch.isfinite(via_kernel).all()), "long cache: non-finite "
          "logits")
    out = {"cache_positions": LONG_CACHE, "start_length": LONG_START,
           "steps": LONG_STEPS,
           "kv_cache_gb": 2 * cache["layers"]["k"].numel()
           * cache["layers"]["k"].element_size() / 1e9,
           "ms_per_step": wall_s / LONG_STEPS * 1e3,
           "device_ms_per_step": dev_s / LONG_STEPS * 1e3,
           "device_busy_share": _busy_share(win["busy_s"], wall_s),
           "decode_kernel_ms_per_step": dec["ms"] / LONG_STEPS,
           "decode_kernel_ms_per_launch": dec["ms_per_launch"],
           "decode_kernel_share": dec["ms"] / (dev_s * 1e3),
           "kernel_vs_plain_rel_l2_last_step": _rel_l2(torch, via_kernel,
                                                       via_plain),
           "kernel_vs_plain_argmax_agree": float(
               (via_kernel.argmax(-1) == via_plain.argmax(-1)).float()
               .mean()),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "top_kernels": [{"name": ev.key[:90],
                            "ms_per_step":
                                ev.self_device_time_total / 1e3 / LONG_STEPS,
                            "launches": ev.count} for ev in kernels[:8]]}
    print("serve long cache: " + json.dumps(out))
    del cache
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:                 # None: an empty layer stack
        yield tree


# ---------------------------------------------------------------------------
# Store edges and resume (ROADMAP item 10), Track-B training (item 14)
# ---------------------------------------------------------------------------

# capped store: ~1.28× the cohort of 500 (fig10's capped smoke point keeps
# 16 rows for a cohort of 12), so every round after the first evicts
CAPPED_CAPACITY = 640
# ResNet-18 wire point (10 of 100 clients a round): a pool of exactly the
# cohort keeps only the last round's clients, so every earlier client
# drawn again comes back from the spill (`_offload_restores_due`)
RESNET_CAPACITY = 10
CAPPED_OFFLOADS = ("host", "memmap")
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_STEPS = 5
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
              "8", "--seq", "128", "--tau", "1", "--theta-u", "0.35",
              "--theta-d-max", "0.6", "--error-feedback", "--seed", "0"]
# the families (ROADMAP item 14), bf16 at their published widths: serve
# points (arch, depth or None for the full depth) and train points (arch,
# depth, seq). Llama-4-Scout (~218 GB) and DeepSeek-V3 are cut in depth
# to fit one card; DeepSeek keeps one dense and one MoE MLA layer.
DEEPSEEK_ARCH = "deepseek-v3-671b"
# The serve points run at full depth. The train points of Mamba2 (48
# layers), Zamba2 (38: four shared-block applications left of seven) and
# HuBERT (48) are cut to FAMILY_TRAIN_LAYERS, InternVL2's full depth, to
# keep the script about 100 s inside its time limit: each train depth also
# sets the leaf widths phase 3c times, and full depth costs about a minute
# more there and in phase 10b (PERF.md §4)
FAMILY_TRAIN_LAYERS = 24
FAMILY_SERVE = {
    "serve_mamba2": ("mamba2-780m", None),
    "serve_zamba2": ("zamba2-1.2b", None),
    "serve_internvl2": ("internvl2-2b", None),
    "serve_llama4": ("llama4-scout-17b-a16e", 2),
    "serve_deepseek": (DEEPSEEK_ARCH, 2),
}
FAMILY_TRAIN = {
    "train_mamba2": ("mamba2-780m", FAMILY_TRAIN_LAYERS, 128),
    "train_zamba2": ("zamba2-1.2b", FAMILY_TRAIN_LAYERS, 128),
    "train_hubert": ("hubert-xlarge", FAMILY_TRAIN_LAYERS, 128),
    # 256 image patches + 128 text tokens: make_batch leaves seq − 256
    "train_internvl2": ("internvl2-2b", None, 384),
    "train_llama4": ("llama4-scout-17b-a16e", 1, 128),
}
# parameter counts, the reference's init_abstract at these depths
FAMILY_PARAMS = {
    "serve_mamba2": 857_219_328, "serve_zamba2": 1_245_814_912,
    "serve_internvl2": 1_891_244_032, "serve_llama4": 6_473_180_160,
    "serve_deepseek": 13_944_134_656, "train_mamba2": 505_840_512,
    "train_zamba2": 887_663_104, "train_hubert": 631_153_920,
    "train_internvl2": 1_891_244_032, "train_llama4": 4_271_078_400,
}
FAMILY_TRAIN_STEPS = 3
# decode vs forward logits of a family, bf16: phase 7's bound, or the
# model's own bf16 noise floor where that is higher (the bf16 forward's
# distance from the same forward with its weights in f32, measured where
# an f32 copy of the weights fits beside them). In f32 the two paths agree
# to 1e-4 (tests/test_torch_families.py); at Mamba2-780M's 48 bf16 layers
# the bf16 forward is 10.4% from the f32 one (H100)
FAMILY_REL_L2 = SERVE_REL_L2
F32_COPY_MAX_BYTES = 30 * 2**30
PROFILED_SERVE, PROFILED_TRAIN = "serve_llama4", "train_zamba2"
DEEPSEEK_PARITY_STEPS, DEEPSEEK_PARITY_BATCH, DEEPSEEK_PARITY_SEQ = 3, 4, 64
# phase 3c times a width that phases 8 and 9 do not use only from here:
# Llama-4-Scout's embedding, 1,034,485,760 elements, the widest
TRACK_B_TIMED_MIN = 1_000_000_000
# the example's size (qwen-115m, f32): cuda vs cpu steps, then the
# learnable stream with a checkpoint
EXAMPLE_PARITY_STEPS, EXAMPLE_PARITY_BATCH, EXAMPLE_PARITY_SEQ = 3, 4, 128
EXAMPLE_STEPS, EXAMPLE_CKPT_STEP = 30, 10
EXAMPLE_BATCH, EXAMPLE_SEQ = 8, 256
# the test of fl/distributed.py (tests/test_torch_distributed.py): loss
# within rtol 2e-6, every leaf within relative L2 1e-5 of the reference's
EXAMPLE_LOSS_RTOL = 2e-6
EXAMPLE_REL_L2 = 1e-5
# phase 5's FLIP_CASCADE for the example's 67,129,856 parameters: its
# upload top-k flips ~60–90 bin-edge elements a step between the card and
# the cpu (236 in 3 steps, H100), where phase 5's 164,134 see 0–4
EXAMPLE_FLIP_CASCADE = 1000


def _leaf_sizes(cfg) -> list:
    """numel of every parameter leaf of ``cfg``, from the port's
    ``init_abstract`` (shapes only, no memory)."""
    from repro_torch.fl import distributed as D
    from repro_torch.models import model as M
    return [x.numel() for x in D.tree_leaves(M.init_abstract(cfg))]


def _track_b_configs() -> dict:
    """Every model the Track-B phases train on the card: phase 8's
    Qwen1.5-4B, phase 9's example, the families' train points and
    DeepSeek-V3's smoke config (phase 10b)."""
    import repro_torch.configs as configs
    out = {TRAIN_ARCH: configs.get(TRAIN_ARCH),
           "example": _load_example().config(),
           "deepseek_smoke": configs.get(DEEPSEEK_ARCH).smoke()}
    for name, (arch, layers, _) in FAMILY_TRAIN.items():
        out[name] = _family_cfg(arch, layers)
    return out


def phase_track_b_kernels(torch, K, timer):
    """Phase 3c: the three compression kernels at every leaf width of the
    Track-B steps of phases 8, 9 and 10b (`_track_b_configs`; one row of
    the whole leaf), before any model is resident: exact against the plain
    versions (Σ|x| within SUM_RTOL), and, at the widths of phases 8 and 9
    and every width of at least TRACK_B_TIMED_MIN elements, one CUDA
    kernel per call and timed as in phase 3 (compress also on x per row,
    the train step's call). Another width is checked and not timed: the
    timings of one width of 10^8 elements or more take about 8 s, and
    there are some twenty such widths among the 68."""
    cfgs = _track_b_configs()
    timed = set(_leaf_sizes(cfgs[TRAIN_ARCH])) | set(
        _leaf_sizes(cfgs["example"]))
    sizes = sorted({n for c in cfgs.values() for n in _leaf_sizes(c)}
                   | set(_pod_shard_sizes()), reverse=True)
    out = {}
    for n in sizes:
        check(n < 2 ** 31, f"leaf of {n} elements: the compressed set's "
              "int32 count would overflow")
        out[n] = phase_kernels(torch, K, timer, n, (1,), (1,), (1,),
                               timed=n in timed or n >= TRACK_B_TIMED_MIN)
        torch.cuda.empty_cache()
    return sizes, out


def _history_tail(h, after: int) -> dict:
    keep = [i for i, r in enumerate(h.rounds) if r > after]
    return {k: [getattr(h, k)[i] for i in keep]
            for k in ("rounds", "sim_time", "traffic_bits", "accuracy",
                      "waiting") + (("wire_bits",) if h.wire_bits else ())}


def _same_run(torch, what, a_flat, a_hist, b_flat, b_hist, after=0):
    check(torch.equal(a_flat.cpu(), b_flat.cpu()),
          f"{what}: global vectors differ")
    check(_history_tail(a_hist, after) == _history_tail(b_hist, after),
          f"{what}: History differs: {_history_tail(a_hist, after)} vs "
          f"{_history_tail(b_hist, after)}")


def _capped_run(torch, K, Simulator, cfg):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    sim = Simulator(cfg)
    hist = sim.run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    expect = sim.executor.kernel_launches()
    for k, want in expect.items():
        check(counts[k] == want, f"capped {cfg.state_offload}: {k} "
              f"launched {counts[k]} times, the steps imply {want}")
    tel = sim.store.telemetry()
    check(tel["capacity"] == cfg.state_capacity and tel["evictions"] > 0,
          f"capped run evicted nothing: {tel}")
    out = {"wall_per_round_s": hist.wall_per_round,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "store": tel, "executor": {
               k: v for k, v in sim.executor.telemetry().items()
               if k in ("restore_error", "chunk_calls", "rounds")},
           "launches": counts}
    return sim, hist, out


def _offload_restores_due(sim) -> int:
    """Rows a pool of exactly the cohort must restore from the spill: the
    clients of each round that were drawn before but not in the round
    just before it (that round's cohort is all the pool holds)."""
    check(sim.store.capacity == sim.n_part, "the pool is not the cohort")
    seen, prev, due = set(), set(), 0
    for e in sim.round_log:
        parts = {int(c) for c in e["parts"]}
        due += len(parts & (seen - prev))
        seen |= parts
        prev = parts
    return due


def phase_capped(torch, K, SimConfig, Simulator, CaesarConfig, main_cfg,
                 twins):
    """Phase 6d: the capped store on the card. The dense HAR point with
    state_capacity CAPPED_CAPACITY: host and memmap offload bit-identical
    (global vector, History) to the uncapped run of phase 6; no offload
    with the restore-error probe: finite, evictions and centroid restores
    counted, restore_error reported. Then the wire path's ResNet-18 point
    (trimmed mean, faults, EF, bf16 pool) with state_capacity
    RESNET_CAPACITY and memmap offload, bit-identical to its uncapped run
    of phase 6c, every spilled row drawn again restored from the spill;
    the spill directory is deleted afterwards. ``twins`` holds the
    uncapped runs of phases 6 and 6c and gets the host run's as
    ``"capped_host"``."""
    import shutil
    out, launches = {}, {}
    g_ref, h_ref = twins["dense"]
    spill = os.path.join(ROOT, "build", "chip_smoke_spill")
    for off in CAPPED_OFFLOADS + ("none",):
        cfg = dataclasses.replace(
            main_cfg, state_capacity=CAPPED_CAPACITY, state_offload=off,
            state_dir=os.path.join(spill, f"har_{off}"),
            measure_eviction_error=off == "none")
        sim, hist, o = _capped_run(torch, K, Simulator, cfg)
        if off == "none":
            err = o["executor"].get("restore_error")
            check(err is not None and err["count"] > 0
                  and o["store"]["restores"]["centroid"] == err["count"]
                  and math.isfinite(err["max"]),
                  f"capped none: restore error not reported: {o}")
            check(bool(torch.isfinite(sim.global_flat).all()),
                  "capped none: non-finite global vector")
            check(all(math.isfinite(a) for a in hist.accuracy),
                  "capped none: bad accuracy")
            o["rel_l2_to_uncapped"] = _rel_l2(
                torch, sim.global_flat.cpu(), g_ref)
        else:
            _same_run(torch, f"capped dense HAR, {off} offload",
                      sim.global_flat, hist, g_ref, h_ref)
            check(o["store"]["restores"]["offload"] > 0,
                  f"capped {off}: no row came back from the spill")
            if off == "host":
                twins["capped_host"] = (sim.global_flat.detach().cpu(),
                                         hist, sim.avail_log,
                                         sim.fault_log)
        o["accuracy"] = hist.accuracy
        out[f"dense_har_{off}"] = o
        launches[f"dense_har_{off}"] = o["launches"]
        print(f"capped dense HAR {off}: " + json.dumps(o))
        del sim
        torch.cuda.empty_cache()
    # ResNet-18 at width 64 through the wire with faults, memmap spill
    wcfg = _wire_cfg(SimConfig, CaesarConfig, "trimmed_mean", True)
    g_w, h_w = twins["wire"]
    cfg = dataclasses.replace(
        wcfg, state_capacity=RESNET_CAPACITY, state_offload="memmap",
        state_dir=os.path.join(spill, "resnet18"))
    sim, hist, o = _capped_run(torch, K, Simulator, cfg)
    _same_run(torch, "capped ResNet-18 wire point, memmap offload",
              sim.global_flat, hist, g_w, h_w)
    due = _offload_restores_due(sim)
    o["offload_restores_due"] = due
    check(due > 0 and o["store"]["restores"]["offload"] == due,
          f"capped ResNet-18: {o['store']['restores']['offload']} rows came "
          f"back from the spill, the draws imply {due}")
    o["spill_bytes_on_disk"] = sum(
        os.stat(os.path.join(dp, f)).st_blocks * 512
        for dp, _, fs in os.walk(os.path.join(spill, "resnet18"))
        for f in fs)
    out["resnet18_wire_memmap"] = o
    launches["resnet18_wire_memmap"] = o["launches"]
    print("capped ResNet-18 wire memmap: " + json.dumps(o))
    del sim
    torch.cuda.empty_cache()
    shutil.rmtree(spill, ignore_errors=True)
    check(not os.path.exists(spill), "the spill directory is still there")
    return out, launches


def _resume_twice(torch, Simulator, cfg, cut, ckpt_dir):
    """The run of ``cut`` rounds → state_dict → CheckpointManager.save →
    restore → a fresh Simulator's load_state_dict → run(start_round=cut+1).
    Returns (resumed simulator, its History, snapshot facts)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    first = Simulator(dataclasses.replace(cfg, rounds=cut))
    first.run()
    snap = first.state_dict()
    del first
    mgr = CheckpointManager(ckpt_dir, keep=1)
    t0 = time.perf_counter()
    path = mgr.save(snap, step=cut)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    t0 = time.perf_counter()
    restored, step = mgr.restore_latest(snap)
    restore_s = time.perf_counter() - t0
    check(step == cut, f"restored step {step}, want {cut}")
    sim = Simulator(cfg)
    sim.load_state_dict(restored)
    hist = sim.run(start_round=cut + 1)
    return sim, hist, {"cut": cut, "checkpoint_bytes": size,
                       "save_s": save_s, "restore_s": restore_s,
                       "deferred_in_flight": len(snap["deferred"]),
                       "offloaded_rows": int(len(
                           snap["store"]["offload_clients"]))}


def _same_logs(what, a, b):
    check(len(a.avail_log) == len(b.avail_log)
          and all(x == y for x, y in zip(a.avail_log, b.avail_log)),
          f"{what}: avail_log differs")
    check(len(a.fault_log) == len(b.fault_log), f"{what}: fault_log length")
    for x, y in zip(a.fault_log, b.fault_log):
        for k in x:
            same = ((x[k] == y[k]).all() if hasattr(x[k], "shape")
                    else x[k] == y[k])
            check(bool(same), f"{what}: fault_log {k} differs in round "
                  f"{x['round']}")


def phase_resume(torch, SimConfig, Simulator, CaesarConfig, main_cfg,
                 twins):
    """Phase 6e: two resumes through CheckpointManager on the card, each
    bit-identical to the straight run (global vector, History tail,
    fault_log, avail_log): the capped dense HAR point with host offload cut
    after round 2 (its straight run is phase 6d's), and fig11's config
    through the loopback wire with faults and diurnal availability, cut at
    a round with deferred uploads in flight."""
    import shutil

    from repro_torch.fl.availability import AvailabilityConfig
    from repro_torch.fl.faults import FaultConfig
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    out = {}
    cfg = dataclasses.replace(main_cfg, state_capacity=CAPPED_CAPACITY,
                              state_offload="host")
    g, h, avail, faults = twins["capped_host"]
    straight = type("Run", (), {"avail_log": avail, "fault_log": faults})
    sim, hist, facts = _resume_twice(torch, Simulator, cfg, 2, ckpt)
    _same_run(torch, "capped HAR resume", sim.global_flat, hist, g, h,
              after=2)
    _same_logs("capped HAR resume", sim, straight)
    out["dense_har_capped_host"] = facts
    print("resume capped dense HAR: " + json.dumps(facts))
    del sim
    fcfg = SimConfig(
        dataset="oppo_ts", rounds=8, n_clients=12, data_scale=0.01,
        eval_every=1, participation=0.75, seed=5,
        dataset_kwargs={"n_features": 64}, device="cuda",
        caesar=CaesarConfig(tau=2, b_max=8, use_error_feedback=True),
        wire="loopback", aggregation="trimmed_mean",
        faults=FaultConfig(dropout_rate=0.1, straggler_deadline=1.2,
                           late_policy="defer", corrupt_rate=0.2,
                           byzantine_frac=0.2, attack="sign_flip",
                           attack_scale=5.0),
        availability=AvailabilityConfig(kind="diurnal", day_rounds=4,
                                        duty=0.6, flake_rate=0.05))
    ref = Simulator(fcfg)
    rh = ref.run()
    cuts = [t + 1 for t, e in enumerate(ref.fault_log)
            if e["n_deferred_out"] > 0 and 2 < t + 1 < fcfg.rounds]
    check(bool(cuts), "fig11 resume: no round leaves a deferred upload")
    sim, hist, facts = _resume_twice(torch, Simulator, fcfg, cuts[0], ckpt)
    check(facts["deferred_in_flight"] > 0, "fig11 resume: nothing in flight")
    _same_run(torch, "fig11 wire resume", sim.global_flat, hist,
              ref.global_flat, rh, after=cuts[0])
    _same_logs("fig11 wire resume", sim, ref)
    facts["wire_bits_equal"] = hist.wire_bits == _history_tail(
        rh, cuts[0])["wire_bits"]
    check(facts["wire_bits_equal"], "fig11 resume: wire bits differ")
    out["fig11_wire_faults_diurnal"] = facts
    print("resume fig11 wire: " + json.dumps(facts))
    shutil.rmtree(ckpt, ignore_errors=True)
    return out


class _FiniteOutputs:
    """While entered, records for each call of ``C.fused_hybrid_roundtrip``
    (a leaf's recovered download) and ``C.fused_topk`` (its sparse upload)
    whether its output is all finite (a device flag; no host wait)."""

    NAMES = ("fused_hybrid_roundtrip", "fused_topk")

    def __init__(self, torch, C):
        self.torch, self.C = torch, C
        self.flags = {k: [] for k in self.NAMES}

    def __enter__(self):
        self._orig = {k: getattr(self.C, k) for k in self.NAMES}
        for k, fn in self._orig.items():
            def wrapped(*a, _fn=fn, _flags=self.flags[k], **kw):
                out = _fn(*a, **kw)
                _flags.append(self.torch.isfinite(out[0]).all())
                return out
            setattr(self.C, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(self.C, k, fn)


def _seeded(torch, what):
    """A patch for the contracts' runs that seeds one violation into the
    ragged engine's chunk step (after its real work)."""
    def patch(sim, patches):
        def make(orig):
            def chunk(store, *args, **kwargs):
                out = orig(store, *args, **kwargs)
                if what == "f64":
                    store.pool.to(torch.float64)
                elif what == "sync":
                    out[0].sum().item()
                else:
                    store.pool = store.pool.clone()
                return out
            return chunk
        patches.wrap(sim.executor, "_tier_chunk_defer", make)
    return patch


ANALYSIS_KERNELS = ("magnitude_histogram", "hybrid_compress", "recover")


def phase_analysis(torch, K) -> dict:
    """Phase 6g: the port's invariant checker on the card (see the module
    docstring): every contract and audit passes, kernels 1-3 launched as
    the checked runs imply, each seeded violation flagged by its own
    contract and by no other."""
    from repro_torch.analysis import contracts as AC
    from repro_torch.analysis.ownership import run_ownership
    out = {}
    t0 = time.perf_counter()
    K.reset_launch_counts()
    reports = AC.run_contracts(device="cuda")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    out["contracts_s"] = time.perf_counter() - t0
    for r in reports:
        print(f"analysis: {r}")
    bad = [str(r) for r in reports if not r.ok]
    check(not bad, "analysis contracts failed on the card: " + "; ".join(bad))
    implied = {k: sum(r.launches[k] for r in reports if r.launches)
               for k in ANALYSIS_KERNELS}
    out["launches"] = {k: counts[k] for k in ANALYSIS_KERNELS}
    for k in ANALYSIS_KERNELS:
        check(counts[k] > 0, f"analysis: {k} never launched")
        check(counts[k] == implied[k], f"analysis: {k} launched "
              f"{counts[k]} times, the checked runs imply {implied[k]}")
    out["contracts"] = [str(r) for r in reports]
    t0 = time.perf_counter()
    own = run_ownership(device="cuda")
    out["ownership_s"] = time.perf_counter() - t0
    for r in own:
        print(f"analysis: {r}")
    bad = [str(r) for r in own if not r.ok]
    check(not bad, "ownership audit failed on the card: " + "; ".join(bad))
    out["ownership"] = [str(r) for r in own]
    t0 = time.perf_counter()
    want = {"f64": ("no-f64", "float64"),
            "sync": ("no-stray-sync", "chip_smoke.py"),
            "realloc": ("in-place", "reallocated")}
    seeded = {}
    for what, (contract, word) in want.items():
        reps = AC.verify_round_engine(True, "cuda", patch=_seeded(torch, what))
        failed = {r.name.split("[")[0]: r for r in reps if not r.ok}
        check(list(failed) == [contract] and word in failed[contract].detail,
              f"analysis: the seeded {what} violation should fail exactly "
              f"{contract}, naming {word!r}; failed: "
              + "; ".join(str(r) for r in failed.values()))
        seeded[what] = str(failed[contract])
        print(f"analysis: seeded {what}: {failed[contract]}")
    out["seeded"] = seeded
    out["seeded_s"] = time.perf_counter() - t0
    return out


def phase_train(torch, K, checked_sizes):
    """Phase 8: Track-B training of Qwen1.5-4B at full width (bf16, random
    weights from a seeded generator) as `python -m
    repro_torch.launch.train` runs it (TRAIN_ARGS): loss finite at every
    step; the histogram twice and compress and recover once per leaf and
    step (all at one row) in the counts zeroed just before the run and read
    just after; every leaf's width among those phase 3c checked; no leaf's
    recovered download or sparse upload non-finite. Then one more step
    profiled for the busy share and the kernels' share of device time."""
    from repro_torch.core import compression as C
    from repro_torch.fl import distributed as D
    from repro_torch.launch import train

    args = train.parser().parse_args(TRAIN_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _FiniteOutputs(torch, C) as fin:
        res = train.run(args, log=print)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = K.launch_counts()
    by_rows = K.launch_counts_by_rows()
    peak = torch.cuda.max_memory_allocated() / 2**30
    state, cfg = res["state"], res["cfg"]
    check(cfg.n_layers == 40 and cfg.d_model == 2560
          and cfg.vocab == 151936 and cfg.dtype == "bfloat16",
          "the train phase must run the published width in bf16")
    sizes = [x.numel() for x in D.tree_leaves(state.params)]
    n_params = sum(sizes)
    check(sorted(sizes) == sorted(_leaf_sizes(cfg)),
          "the model's leaves are not the ones phase 3c sized")
    check(set(sizes) <= set(checked_sizes), "a leaf width was not checked "
          "in phase 3c")
    check(all(math.isfinite(x) for x in res["losses"])
          and len(res["losses"]) == TRAIN_STEPS, f"losses {res['losses']}")
    leaves, steps = len(sizes), TRAIN_STEPS
    want = {"magnitude_histogram": 2 * leaves * steps,
            "hybrid_compress": leaves * steps, "recover": leaves * steps,
            "decode_attention": 0}
    check(counts == want, f"train path launches {counts}, want {want}")
    for name, per in by_rows.items():
        check(set(per) <= {1} and sum(per.values()) == counts[name],
              f"train path: {name} ran at rows {per}, want one row")
    for k, flags in fin.flags.items():
        check(len(flags) == leaves * steps, f"{k} ran {len(flags)} times, "
              f"want once per leaf and step ({leaves * steps})")
        check(bool(torch.stack(flags).all()),
              f"a leaf's {k} output holds a non-finite value")
    walls, losses = res["walls"], res["losses"]
    warm = sorted(walls[1:])
    wall = warm[len(warm) // 2]
    # one more step under the profiler, on the same state and a batch of
    # the same stream
    from repro_torch.core import rng as RNG
    batch = train.make_batch(RNG.stream(1, RNG.KIND_DATASET), cfg,
                             args.batch, args.seq, torch.device("cuda"))
    step_fn = res["step_fn"]
    del res
    box = {"state": state}
    del state

    def one():
        box["state"], _ = step_fn(box["state"], batch)
    kernels, dev_s, win = _profile_kernels(torch, one,
                                           "profile_train_qwen4b.txt")
    ours = {}
    for ev in kernels:
        for name in ("magnitude_histogram_kernel", "hybrid_compress_kernel",
                     "recover_kernel"):
            if name in ev.key:
                ours[name] = ours.get(name, 0.0) + (
                    ev.self_device_time_total / 1e3)
    out = {"params": n_params, "leaves": leaves, "losses": losses,
           "step_walls_s": walls, "run_s": run_s,
           "ms_per_step": wall * 1e3,
           "tokens_per_s": args.batch * args.seq / wall,
           "peak_mem_gb": peak, "launches": counts,
           "launches_by_rows": by_rows,
           "profiled_step": {
               "device_kernel_s": dev_s, "device_busy_s": win["busy_s"],
               "profiled_step_wall_s": win["profiled_run_s"],
               "device_busy_share": _busy_share(win["busy_s"], wall),
               "compression_kernels_ms": ours,
               "compression_kernels_share_of_device": (
                   sum(ours.values()) / 1e3 / dev_s if dev_s else None),
               "top_kernels": [{"name": ev.key[:90],
                                "ms": ev.self_device_time_total / 1e3,
                                "launches": ev.count}
                               for ev in kernels[:15]]}}
    print("train path (Qwen1.5-4B, Track B): " + json.dumps(out))
    del box, step_fn, batch
    torch.cuda.empty_cache()
    return out


def _load_example():
    """examples/train_lm_cohort_torch.py as a module (its config, batch
    stream and Caesar settings)."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "train_lm_cohort_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_cohort_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CallMasks:
    """While entered, records on the host each call's selection: the int8
    sign mask of a ``C.fused_compress`` (0 marks a full-precision slot) or
    the dropped mask of a ``C.topk_sparsify_at`` — the Track-B step's
    download and upload."""

    def __init__(self, C):
        self.C, self.calls = C, []

    def __enter__(self):
        C = self.C
        fc, tk = self._orig = (C.fused_compress, C.topk_sparsify_at)

        def compress(x, thr):
            out = fc(x, thr)
            self.calls.append(out[1].cpu())
            return out

        def topk(g, thr):
            self.calls.append((g.abs() < thr.reshape(-1, 1)).cpu())
            return tk(g, thr)
        C.fused_compress, C.topk_sparsify_at = compress, topk
        return self

    def __exit__(self, *exc):
        self.C.fused_compress, self.C.topk_sparsify_at = self._orig


def _example_parity(torch, ex, D, M, C, RNG):
    """cuda vs cpu for EXAMPLE_PARITY_STEPS steps of the example's model
    (`_cuda_cpu_parity`)."""
    cfg = ex.config()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = RNG.stream(0, RNG.KIND_DATASET)
    batches = [ex.batch_at(rng, t, EXAMPLE_PARITY_BATCH, EXAMPLE_PARITY_SEQ,
                           cfg.vocab, "cpu")
               for t in range(EXAMPLE_PARITY_STEPS)]
    return _cuda_cpu_parity(torch, D, C, cfg, ex.DIST, params, batches,
                            "example")


def _cuda_cpu_parity(torch, D, C, cfg, dcfg, params, batches, what):
    """cuda vs cpu for one train step per batch from one initial state
    (``params``, on the cpu): loss within EXAMPLE_LOSS_RTOL and every
    parameter leaf within EXAMPLE_REL_L2 (the test of fl/distributed.py's
    bounds) outside the elements whose selection flipped so far, counted
    from the sign and drop masks (phase 5's rule; past
    EXAMPLE_FLIP_CASCADE flips the steps are reported, not gated)."""
    runs = {}
    for dev in ("cuda", "cpu"):
        p = D.tree_map(lambda a: a.to(dev, copy=True), params)
        state = D.init_state(p, dcfg)
        step = D.make_train_step(cfg, dcfg, device=dev)
        losses, trees, masks = [], [], []
        for b in batches:
            with _CallMasks(C) as m:
                state, met = step(state, {k: v.to(dev)
                                          for k, v in b.items()})
            losses.append(float(met["loss"]))
            trees.append([x.detach().cpu() for x in
                          D.tree_leaves(state.params)])
            masks.append(m.calls)
        runs[dev] = (losses, trees, masks)
        del state, step, p
    (lg, tg, mg), (lc, tc, mc) = runs["cuda"], runs["cpu"]
    steps, total = [], 0
    for t in range(len(batches)):
        check(len(mg[t]) == len(mc[t]), f"{what}: the call streams differ")
        flips = sum(int((a != b).sum()) for a, b in zip(mg[t], mc[t]))
        total += flips
        worst = 0.0
        for a, b in zip(tg[t], tc[t]):
            d = (a - b).reshape(-1)
            kept = torch.ones_like(d, dtype=torch.bool)
            if total:
                kept[torch.topk(d.abs(), min(total, d.numel())).indices] = \
                    False
            worst = max(worst, float(torch.linalg.vector_norm(d[kept])
                                     / torch.linalg.vector_norm(b)))
        gated = total <= EXAMPLE_FLIP_CASCADE
        rl = abs(lg[t] - lc[t]) / abs(lc[t])
        steps.append({"step": t, "flips": flips, "flips_so_far": total,
                      "max_leaf_rel_l2": worst, "loss_cuda": lg[t],
                      "loss_cpu": lc[t], "loss_rel": rl, "gated": gated})
        if gated:
            check(rl <= EXAMPLE_LOSS_RTOL, f"{what} step {t}: loss "
                  f"{lg[t]} on the card vs {lc[t]} on the cpu")
            check(worst <= EXAMPLE_REL_L2, f"{what} step {t}: a leaf is "
                  f"{worst} apart outside {total} flipped elements")
    return steps


def phase_train_example(torch, K, checked_sizes):
    """Phase 9: Track B at the example's size (qwen-115m, f32, TF32 off): cuda
    vs cpu (`_example_parity`); then EXAMPLE_STEPS steps of the example's
    learnable stream on the card with the loss falling (the mean of the
    last 5 below the mean of the first 5), the histogram twice and compress
    and recover once per leaf and step, all at one row and at widths phase
    3c checked, in the counts of those steps; a CheckpointManager checkpoint
    after step EXAMPLE_CKPT_STEP, restored into a fresh state, whose
    remaining steps are bit-identical (losses, params, stale model,
    residuals) to the straight run's."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import compression as C
    from repro_torch.core import rng as RNG
    from repro_torch.fl import distributed as D
    from repro_torch.models import model as M
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    ex = _load_example()
    t0 = time.perf_counter()
    parity = _example_parity(torch, ex, D, M, C, RNG)
    parity_s = time.perf_counter() - t0
    cfg = ex.config()
    dev = torch.device("cuda")
    n_params = None

    def fresh(seed):
        nonlocal n_params
        p = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
        n_params = sum(x.numel() for x in D.tree_leaves(p))
        return D.init_state(p, ex.DIST)
    rng = RNG.stream(0, RNG.KIND_DATASET)
    batches = [ex.batch_at(rng, t, EXAMPLE_BATCH, EXAMPLE_SEQ, cfg.vocab, dev)
               for t in range(EXAMPLE_STEPS)]
    step = D.make_train_step(cfg, ex.DIST, device=dev)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(ckpt, keep=1)
    state = fresh(0)
    K.reset_launch_counts()
    losses, walls = [], []
    for t in range(EXAMPLE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = step(state, batches[t])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        losses.append(met["loss"])
        if t + 1 == EXAMPLE_CKPT_STEP:
            mgr.save(state, t + 1)
    counts = K.launch_counts()
    by_rows = K.launch_counts_by_rows()
    sizes = [x.numel() for x in D.tree_leaves(state.params)]
    check(sorted(sizes) == sorted(_leaf_sizes(cfg)),
          "the example's leaves are not the ones phase 3c sized")
    check(set(sizes) <= set(checked_sizes), "an example leaf width was not "
          "checked in phase 3c")
    leaves = len(sizes)
    want = {"magnitude_histogram": 2 * leaves * EXAMPLE_STEPS,
            "hybrid_compress": leaves * EXAMPLE_STEPS,
            "recover": leaves * EXAMPLE_STEPS, "decode_attention": 0}
    check(counts == want, f"example launches {counts}, want {want}")
    for name, per in by_rows.items():
        check(set(per) <= {1} and sum(per.values()) == counts[name],
              f"example: {name} ran at rows {per}, want one row")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    first, last = (sum(losses[:5]) / 5, sum(losses[-5:]) / 5)
    check(last < first, f"the loss did not fall: {losses}")
    restored, at = mgr.restore_latest(fresh(1))
    check(at == EXAMPLE_CKPT_STEP, f"restored step {at}")
    check(int(restored.step) == EXAMPLE_CKPT_STEP, "restored step counter")
    tail = []
    for t in range(EXAMPLE_CKPT_STEP, EXAMPLE_STEPS):
        restored, met = step(restored, batches[t])
        tail.append(float(met["loss"]))
    check(tail == losses[EXAMPLE_CKPT_STEP:], "resumed losses differ: "
          f"{tail} vs {losses[EXAMPLE_CKPT_STEP:]}")
    for name in ("params", "prev_params", "ef"):
        for a, b in zip(D.tree_leaves(getattr(restored, name)),
                        D.tree_leaves(getattr(state, name))):
            check(torch.equal(a, b), f"resumed {name} differ from the "
                  "straight run's")
    warm = sorted(walls[1:])
    out = {"params": n_params, "parity": parity, "parity_s": parity_s,
           "losses": losses, "loss_first5_mean": first,
           "loss_last5_mean": last, "resumed_bit_identical": True,
           "ms_per_step": warm[len(warm) // 2] * 1e3,
           "tokens_per_s": EXAMPLE_BATCH * EXAMPLE_SEQ / warm[len(warm) // 2],
           "launches": counts, "launches_by_rows": by_rows}
    print("train example (qwen-115m): " + json.dumps(out))
    del state, restored, batches, step
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The other families (ROADMAP item 14): serving and Track-B training
# ---------------------------------------------------------------------------

def _family_cfg(arch: str, layers):
    """``arch``'s published config, its depth cut to ``layers`` if given
    (one dense layer kept where the model has a dense prefix)."""
    import repro_torch.configs as configs
    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, n_dense_layers=min(
            cfg.n_dense_layers, 1))
    return cfg


def _attention_apps(M, cfg) -> int:
    """decode_attention launches of one decode step: one per GQA layer,
    one per shared-block application of the hybrid, none for Mamba2 and
    MLA (whose absorbed decode is plain torch)."""
    if cfg.family == "ssm" or cfg.use_mla:
        return 0
    if cfg.family == "hybrid":
        return len(M._hybrid_segments(cfg))
    return cfg.n_layers


def _routed(torch, MOE, fn):
    """``fn()`` and the routes of its MoE calls (`moe.record_routes`)."""
    MOE.record_routes = []
    try:
        out = fn()
        return out, MOE.record_routes
    finally:
        MOE.record_routes = None


def _decode_routes(torch, routes, n_moe: int, steps: int) -> list:
    """Per MoE layer, the [B, steps, K] experts of a teacher-forced decode
    (its calls go step by step, layer by layer)."""
    return [torch.stack([routes[i * n_moe + layer][0]
                         for i in range(steps)], dim=1)
            for layer in range(n_moe)]


def _same_route_prefix(torch, bad, steps: int) -> list:
    """Per row, the positions before its first ``bad`` one ([B, steps]
    bool): a token routed to other experts on the two paths, or dropped
    to capacity on one. A causal position sees only earlier ones, so
    those are the positions a routing difference cannot have reached."""
    out = []
    for row in bad.cpu():
        hit = torch.nonzero(row)
        out.append(int(hit[0, 0]) if len(hit) else steps)
    return out


def _rel_prefix(torch, a, b, clean) -> float:
    """rel L2 of a [steps, B, V] decode against b (the same layout) over
    each row's first clean[r] steps."""
    return _rel_l2(torch, torch.cat([a[:c, r] for r, c in enumerate(clean)]),
                   torch.cat([b[:c, r] for r, c in enumerate(clean)]))


def _serve_family(torch, K, name, arch, layers) -> dict:
    from repro_torch.core import rng as RNG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    cfg = _family_cfg(arch, layers)
    check(cfg.dtype == "bfloat16", f"{name}: not bf16")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    check(n_params == FAMILY_PARAMS[name], f"{name}: {n_params} parameters, "
          f"want {FAMILY_PARAMS[name]} (the published width)")
    b = SERVE_BATCH
    prompt = torch.from_numpy(RNG.stream(0, RNG.KIND_DATASET).integers(
        0, cfg.vocab, (b, SERVE_PROMPT))).to(dev, torch.int32)
    steps = SERVE_PROMPT + SERVE_NEW - 1

    # the serve path, counted
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = M.generate(params, cfg, prompt, SERVE_NEW)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = K.launch_counts()
    apps = _attention_apps(M, cfg)
    check(counts["decode_attention"] == apps * steps,
          f"{name}: decode_attention launched {counts['decode_attention']} "
          f"times, want {apps} per step × {steps} steps")
    check(all(n == 0 for k, n in counts.items() if k != "decode_attention"),
          f"{name}: a compression kernel launched on the serve path")
    check(tuple(out.shape) == (b, SERVE_NEW)
          and bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"{name}: bad tokens")
    # a warm same-seed rerun: latency, and the same tokens
    t0 = time.perf_counter()
    again = M.generate(params, cfg, prompt, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(again, out), f"{name}: same-seed reruns differ")

    # teacher-forced decode twice (bit for bit; no capacity drop at B
    # tokens a step), then the plain decode_attention path, then forward
    # over the same tokens (text only for the VLM), each with its routes
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
    seq = torch.cat([prompt, out], dim=1)
    via_kernel, routes_k = _routed(torch, MOE, lambda: _teacher_forced(
        torch, M, params, cfg, seq))
    rerun = _teacher_forced(torch, M, params, cfg, seq)
    check(torch.equal(via_kernel, rerun), f"{name}: two teacher-forced "
          "decodes of the same tokens differ")
    check(not any(bool(d.any()) for _, d in routes_k),
          f"{name}: a decode step dropped a token to capacity")
    check(bool(torch.isfinite(via_kernel).all()), f"{name}: non-finite "
          "logits")
    dec_ids = _decode_routes(torch, routes_k, n_moe, steps)
    batch = {"tokens": seq[:, :steps]}
    if cfg.frontend == "vision":
        batch["patches"] = torch.zeros((b, 0, cfg.frontend_dim), device=dev)
    with torch.no_grad():
        fwd, routes_f = _routed(torch, MOE, lambda: M.forward(
            params, batch, cfg).float())
    fwd = fwd.transpose(0, 1)                       # [steps, B, V]
    # the bf16 noise floor: the same forward with the weights in f32
    floor = None
    if n_params * 4 <= F32_COPY_MAX_BYTES:
        from repro_torch.fl import distributed as D
        p32 = D.tree_map(lambda t: t.float(), params)
        with torch.no_grad():
            f32 = M.forward(p32, batch, dataclasses.replace(
                cfg, dtype="float32")).float().transpose(0, 1)
        del p32
        floor = _rel_l2(torch, fwd, f32)
        del f32
        torch.cuda.empty_cache()
    bound = max(FAMILY_REL_L2, floor or 0.0)
    # decode vs forward, before each row's first token routed otherwise or
    # dropped in the forward
    bad = torch.zeros((b, steps), dtype=torch.bool, device=dev)
    for layer, (ids, dropped) in enumerate(routes_f):
        bad |= dropped.reshape(b, steps) | (ids.reshape(b, steps, -1)
                                            != dec_ids[layer]).any(-1)
    clean_f = _same_route_prefix(torch, bad, steps)
    rel_fwd = _rel_prefix(torch, via_kernel, fwd, clean_f)
    check(rel_fwd <= bound, f"{name}: decode vs forward logits rel L2 "
          f"{rel_fwd:.3g} > {FAMILY_REL_L2} and > the bf16 forward's own "
          f"distance from f32 ({floor}) over {sum(clean_f)} positions")
    # at the published capacity a MoE forward drops most rows early (a
    # top-8 of 256 experts over 188 tokens gives each expert 8 slots for
    # ~5.9 tokens on average), so the forward is compared again with room
    # for every token in every expert: it drops none, as decode does not
    rel_ample, clean_a = None, None
    if n_moe:
        ample = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
        with torch.no_grad():
            fwd_a, routes_a = _routed(torch, MOE, lambda: M.forward(
                params, batch, ample).float())
        check(not any(bool(d.any()) for _, d in routes_a),
              f"{name}: the forward with room for every token dropped one")
        bad = torch.zeros((b, steps), dtype=torch.bool, device=dev)
        for layer, (ids, _) in enumerate(routes_a):
            bad |= (ids.reshape(b, steps, -1) != dec_ids[layer]).any(-1)
        clean_a = _same_route_prefix(torch, bad, steps)
        rel_ample = _rel_prefix(torch, via_kernel, fwd_a.transpose(0, 1),
                                clean_a)
        check(rel_ample <= bound, f"{name}: decode vs the forward without "
              f"drops, logits rel L2 {rel_ample:.3g} > {bound} over "
              f"{sum(clean_a)} positions")
        del fwd_a
    rel, clean_p = None, None
    if apps:
        M.decode_attention = FA.decode_attention_plain
        try:
            via_plain, routes_p = _routed(torch, MOE, lambda: _teacher_forced(
                torch, M, params, cfg, seq))
        finally:
            M.decode_attention = FA.decode_attention
        bad = torch.zeros((b, steps), dtype=torch.bool, device=dev)
        for a, c in zip(dec_ids, _decode_routes(torch, routes_p, n_moe,
                                                steps)):
            bad |= (a != c).any(-1)
        clean_p = _same_route_prefix(torch, bad, steps)
        rel = _rel_prefix(torch, via_kernel, via_plain, clean_p)
        check(rel <= bound, f"{name}: kernel vs plain logits rel L2 "
              f"{rel:.3g} > {FAMILY_REL_L2} and > the bf16 forward's own "
              f"distance from f32 ({floor}) over {sum(clean_p)} positions")
        del via_plain
    res = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params,
        "init_s": init_s, "decode_steps": steps, "cold_wall_s": cold_s,
        "warm_wall_s": wall, "ms_per_step": wall / steps * 1e3,
        "tokens_per_s": b * SERVE_NEW / wall,
        "decode_tokens_per_s": b * steps / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "attention_apps_per_step": apps,
        "bf16_forward_vs_f32_rel_l2": floor, "bound": bound,
        "kernel_vs_plain_rel_l2": rel,
        "kernel_vs_plain_positions": sum(clean_p) if clean_p else None,
        "decode_vs_forward_rel_l2": rel_fwd,
        "decode_vs_forward_positions": sum(clean_f),
        "decode_vs_forward_no_drop_rel_l2": rel_ample,
        "decode_vs_forward_no_drop_positions": (sum(clean_a) if clean_a
                                                else None),
        "forward_capacity_drops": int(sum(int(d.sum()) for _, d in
                                          routes_f)),
        "positions": b * steps, "sample": out[0, :8].tolist()}
    del fwd, via_kernel, rerun
    if name == PROFILED_SERVE:
        window = seq[:, :PROFILE_STEPS + 1]
        t0 = time.perf_counter()
        _teacher_forced(torch, M, params, cfg, window)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        kernels, dev_s, win = _profile_kernels(
            torch, lambda: _teacher_forced(torch, M, params, cfg, window),
            f"profile_{name}.txt")
        d = _decode_events(kernels, apps * PROFILE_STEPS)
        res["profile"] = {
            "steps": PROFILE_STEPS, "window_wall_s": window_s,
            "device_s_per_step": dev_s / PROFILE_STEPS,
            "device_busy_share": _busy_share(win["busy_s"], window_s),
            "decode_kernel_ms_per_launch": d["ms_per_launch"],
            "decode_kernel_share": d["ms"] / (dev_s * 1e3),
            "top_kernels": [{"name": ev.key[:90],
                             "ms": ev.self_device_time_total / 1e3,
                             "launches": ev.count} for ev in kernels[:12]]}
    del params
    torch.cuda.empty_cache()
    return res


def phase_serve_families(torch, K):
    """Phase 10: each family's serve point (FAMILY_SERVE, bf16, published
    widths, random weights from a seeded generator) through `generate` at
    phase 7's shape (4 prompts × 16 tokens, 32 new): decode_attention
    launched once per attention application and step (none for Mamba2 and
    DeepSeek's MLA), a same-seed rerun bit-identical, two teacher-forced
    decodes bit-identical with no capacity drop, the kernel path's logits
    against the plain path's and decode's against `forward`'s at the same
    positions (for a MoE: before each row's first token routed otherwise
    or dropped, and again against a forward with room for every token)
    within rel L2 5e-2, or the model's bf16 noise floor where that is
    higher (FAMILY_REL_L2); ms per step, tokens/s and peak memory, and one
    profiled window of PROFILED_SERVE."""
    out = {}
    for name, (arch, layers) in FAMILY_SERVE.items():
        out[name] = _serve_family(torch, K, name, arch, layers)
        print(f"{name}: " + json.dumps(out[name]))
    return out


def _train_family(torch, K, name, arch, layers, seq, checked_sizes):
    from repro_torch.core import compression as C
    from repro_torch.fl import distributed as D
    from repro_torch.launch import train

    cfg = _family_cfg(arch, layers)
    args = train.parser().parse_args(
        ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--batch", "8",
         "--seq", str(seq), "--tau", "1", "--theta-u", "0.35",
         "--theta-d-max", "0.6", "--error-feedback", "--seed", "0"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with _FiniteOutputs(torch, C) as fin:
        res = train.run(args, log=lambda line: None,
                        cfg=cfg if layers else None)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    by_rows = K.launch_counts_by_rows()
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = res["state"]
    check(res["cfg"].n_layers == cfg.n_layers
          and res["cfg"].d_model == cfg.d_model
          and res["cfg"].dtype == "bfloat16", f"{name}: wrong config")
    sizes = [x.numel() for x in D.tree_leaves(state.params)]
    check(sum(sizes) == FAMILY_PARAMS[name], f"{name}: {sum(sizes)} "
          f"parameters, want {FAMILY_PARAMS[name]}")
    check(set(sizes) <= set(checked_sizes), f"{name}: a leaf width was not "
          "checked in phase 3c")
    losses = res["losses"]
    check(len(losses) == FAMILY_TRAIN_STEPS
          and all(math.isfinite(x) for x in losses), f"{name}: losses "
          f"{losses}")
    leaves, steps = len(sizes), FAMILY_TRAIN_STEPS
    want = {"magnitude_histogram": 2 * leaves * steps,
            "hybrid_compress": leaves * steps, "recover": leaves * steps,
            "decode_attention": 0}
    check(counts == want, f"{name}: launches {counts}, want {want}")
    for k, per in by_rows.items():
        check(set(per) <= {1} and sum(per.values()) == counts[k],
              f"{name}: {k} ran at rows {per}, want one row")
    for k, flags in fin.flags.items():
        check(len(flags) == leaves * steps, f"{name}: {k} ran {len(flags)} "
              f"times, want {leaves * steps}")
        check(bool(torch.stack(flags).all()), f"{name}: a leaf's {k} "
              "output holds a non-finite value")
    walls = res["walls"]
    warm = sorted(walls[1:])
    wall = warm[len(warm) // 2]
    tokens = args.batch * args.seq
    out = {"arch": res["cfg"].name, "n_layers": cfg.n_layers,
           "params": sum(sizes), "leaves": leaves, "seq": seq,
           "losses": losses, "step_walls_s": walls,
           "ms_per_step": wall * 1e3, "tokens_per_s": tokens / wall,
           "peak_mem_gb": peak, "launches": counts}
    step_fn = res["step_fn"]
    del res
    from repro_torch.core import rng as RNG
    batch = train.make_batch(RNG.stream(1, RNG.KIND_DATASET), cfg,
                             args.batch, args.seq, torch.device("cuda"))
    if name == "train_llama4":
        out["rerun"] = _same_step_twice(torch, D, step_fn, state, batch, name)
    if name == PROFILED_TRAIN:
        box = {"state": state}

        def one():
            box["state"], _ = step_fn(box["state"], batch)
        kernels, dev_s, win = _profile_kernels(torch, one,
                                               f"profile_{name}.txt")
        ours = {}
        for ev in kernels:
            for k in ("magnitude_histogram_kernel", "hybrid_compress_kernel",
                      "recover_kernel"):
                if k in ev.key:
                    ours[k] = ours.get(k, 0.0) + (
                        ev.self_device_time_total / 1e3)
        out["profiled_step"] = {
            "device_kernel_s": dev_s, "device_busy_s": win["busy_s"],
            "device_busy_share": _busy_share(win["busy_s"], wall),
            "compression_kernels_ms": ours,
            "compression_kernels_share_of_device": (
                sum(ours.values()) / 1e3 / dev_s if dev_s else None),
            "top_kernels": [{"name": ev.key[:90],
                             "ms": ev.self_device_time_total / 1e3,
                             "launches": ev.count} for ev in kernels[:15]]}
        del box
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return out


def _same_step_twice(torch, D, step_fn, state, batch, name) -> dict:
    """One train step from ``state`` on ``batch``, twice: losses, new
    params, stale model and residuals equal bit for bit (the MoE combine
    and dispatch fold in a fixed order). The first run's new state waits
    on the host, so that the card holds one new state at a time (two
    do not fit beside the old one at Llama-4-Scout's width)."""
    a, ma = step_fn(state, batch)
    names = ("params", "prev_params", "ef")
    host = {k: [x.cpu() for x in D.tree_leaves(getattr(a, k))]
            for k in names}
    del a
    torch.cuda.empty_cache()
    b, mb = step_fn(state, batch)
    check(torch.equal(ma["loss"], mb["loss"]), f"{name}: rerun loss differs")
    for k in names:
        check(all(torch.equal(x, y.cpu()) for x, y in
                  zip(host[k], D.tree_leaves(getattr(b, k)))),
              f"{name}: rerun {k} differ")
    del b, host
    torch.cuda.empty_cache()
    return {"loss": float(ma["loss"]), "bit_identical": True}


def _deepseek_parity(torch, checked_sizes) -> dict:
    """DeepSeek-V3 at its smoke config (f32; MLA, a dense layer, top-2 of 8
    routed experts and a shared one), cuda vs cpu for
    DEEPSEEK_PARITY_STEPS Track-B steps with phase 8's Caesar settings
    (`_cuda_cpu_parity`); its leaf widths were checked in phase 3c. Its
    full width does not train on one card (ROADMAP item 13c)."""
    import repro_torch.configs as configs
    from repro_torch.core import compression as C
    from repro_torch.core import rng as RNG
    from repro_torch.fl import distributed as D
    from repro_torch.launch import train
    from repro_torch.models import model as M
    cfg = configs.get(DEEPSEEK_ARCH).smoke()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sizes = [x.numel() for x in D.tree_leaves(params)]
    check(set(sizes) <= set(checked_sizes), "deepseek smoke: a leaf width "
          "was not checked in phase 3c")
    rng = RNG.stream(0, RNG.KIND_DATASET)
    batches = [train.make_batch(rng, cfg, DEEPSEEK_PARITY_BATCH,
                                DEEPSEEK_PARITY_SEQ, "cpu")
               for _ in range(DEEPSEEK_PARITY_STEPS)]
    dcfg = D.DistConfig(theta_d=0.3, theta_u=0.35, local_lr=3e-2,
                        use_error_feedback=True)
    steps = _cuda_cpu_parity(torch, D, C, cfg, dcfg, params, batches,
                             "deepseek smoke")
    return {"params": sum(sizes), "steps": steps}


def phase_train_families(torch, K, checked_sizes):
    """Phase 10b: Track B of each family's train point (FAMILY_TRAIN, bf16,
    published widths, Llama-4-Scout at depth 1 through ``train.run``'s
    config override) as phase 8 runs it, FAMILY_TRAIN_STEPS steps: finite
    losses, launches 2/1/1 per leaf and step at one row, every leaf width
    among phase 3c's, no non-finite recovered download or upload; ms per
    step, tokens/s, peak memory. Llama-4-Scout's last state then takes one
    more step twice, bit for bit (`_same_step_twice`); PROFILED_TRAIN's
    one profiled step. Then DeepSeek-V3's smoke config cuda vs cpu."""
    out = {}
    for name, (arch, layers, seq) in FAMILY_TRAIN.items():
        out[name] = _train_family(torch, K, name, arch, layers, seq,
                                  checked_sizes)
        print(f"{name}: " + json.dumps(out[name]))
    out["deepseek_smoke_parity"] = _deepseek_parity(torch, checked_sizes)
    print("deepseek smoke cuda vs cpu: "
          + json.dumps(out["deepseek_smoke_parity"]))
    return out


TRACK_B_TIMER = dict(windows=5, iters=3)   # rows of 10^8 elements: short


# ---------------------------------------------------------------------------
# Phase 11: Track B over a pod mesh (ROADMAP item 13's Track-B half)
# ---------------------------------------------------------------------------

POD_WORLD = 4                    # gloo ranks sharing cuda:0
POD_TIMEOUT_S = 900.0
POD_NAMES = ("pod", "data", "model")
# (a) the reference's multipod test config and Llama-4-Scout's smoke
# config, with a capacity of every token routed there both for a data
# rank's 64 tokens and for the pod's 128 (so the meshless composition,
# which routes a pod's micro-batch at once, drops none either)
POD_MULTIPOD = dict(local_iters=1, d_model=64, n_heads=2, n_kv_heads=2,
                    d_head=32, vocab=128)
POD_PARITY = {
    "parity_qwen": ("qwen1.5-4b", POD_MULTIPOD, (2, 2, 1)),
    "parity_llama4": ("llama4-scout-17b-a16e", dict(capacity_factor=8.0),
                      (1, 2, 2)),
}
POD_PARITY_STEPS, POD_PARITY_BATCH, POD_PARITY_SEQ = 2, 8, 16
POD_PARITY_DIST = dict(theta_d=0.3, theta_u=0.35, local_lr=1e-2,
                       use_error_feedback=True)
# the gates of tests/test_torch_pod_mesh.py: loss rtol 2e-6, params and
# stale models rel. L2 1e-5; residuals 5e-4 (plus 2 ulps of their weight
# where held) outside at most POD_FLIP_MAX flipped elements (measured 0–8
# on the H100), per expert for the routed experts, at most POD_MOVED_MAX
# slices beyond
POD_FLIP_MAX, POD_MOVED_MAX, POD_EF_REL, POD_ULPS = 16, 1, 5e-4, 2
# (b), (c): published widths, bf16, phase 8's settings: (arch, depth,
# mesh shape, extra launcher flags). Qwen1.5-4B's depth is cut below what
# two pods' state, four ranks on one card, leaves room for (8 layers fit,
# 12 did not: PERF.md §4), to 4, so that the script with phase 12 stays
# well inside its time limit; Llama-4-Scout at phase 10b's depth 1 and
# without error feedback, whose residual (one more copy of every rank's
# shards) does not fit beside the rest
POD_QWEN_LAYERS = 4
POD_FULL = {
    "pod_qwen": ("qwen1.5-4b", POD_QWEN_LAYERS, (2, 2, 1),
                 ["--error-feedback"]),
    "pod_llama4": ("llama4-scout-17b-a16e", 1, (1, 2, 2), []),
}
POD_STEPS = 2
POD_TRAIN_ARGS = ["--steps", str(POD_STEPS), "--batch", "8", "--seq", "128",
                  "--tau", "1", "--theta-u", "0.35", "--theta-d-max", "0.6",
                  "--seed", "0"]


def _pod_shard_sizes(full=None) -> list:
    """numel of every leaf shard of phase 11's full-width points (for
    phase 3c)."""
    from repro_torch.fl import distributed as D
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    out = []
    for arch, layers, shape, _ in (full or POD_FULL).values():
        cfg = _family_cfg(arch, layers)
        mesh = MESH.abstract_mesh(shape, POD_NAMES)
        for x, sp in zip(D.tree_leaves(M.init_abstract(cfg)),
                         D.tree_leaves(M.param_specs(cfg, mesh))):
            out.append(x.numel() // mesh.size_over(SH.spec_axes(sp)))
    return out


def _pod_batches(torch, cfg):
    import numpy as np
    rng = np.random.default_rng(11)
    out = []
    for _ in range(POD_PARITY_STEPS):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (
            POD_PARITY_BATCH, POD_PARITY_SEQ)).astype(np.int32))
        out.append({"tokens": t, "labels": t.clone()})
    return out


def _state_cpu(D, state) -> dict:
    return {f: (None if getattr(state, f) is None else D.tree_map(
        lambda a: a.detach().cpu(), getattr(state, f)))
        for f in ("params", "prev_params", "ef")}


def _fingerprint(torch, x):
    """The exact integer sum of a tensor's raw bits (replicas of one shard
    must give the same)."""
    raw = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(raw).to(torch.int64).sum()


def _pod_parity_rank(torch, D, M, configs, mesh_of) -> dict:
    """(a) on this rank: each parity point on the card twice and on the
    cpu once, from one seeded initial model; the gathered states."""
    out = {}
    for name, (arch, over, shape) in POD_PARITY.items():
        cfg = dataclasses.replace(configs.get(arch).smoke(), **over)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batches = _pod_batches(torch, cfg)
        dcfg = D.DistConfig(**POD_PARITY_DIST)
        res = {}
        for dev, runs in (("cuda", 2), ("cpu", 1)):
            mesh = mesh_of(shape, dev)
            for i in range(runs):
                p = D.tree_map(lambda a: a.to(mesh.device, copy=True), params)
                st = D.init_state(p, dcfg, mesh, cfg)
                del p
                step = D.make_train_step(cfg, dcfg, mesh, dev)
                losses = []
                for b in batches:
                    st, m = step(st, {k: v.to(mesh.device)
                                      for k, v in b.items()})
                    losses.append(float(m["loss"]))
                res[f"{dev}{i}"] = {"losses": losses, "state": _state_cpu(
                    D, D.gather_state(st, cfg, dcfg, mesh))}
        out[name] = res
    return out


def _pod_full_rank(torch, K, D, M, train, arch, layers, flags,
                   mesh) -> dict:
    """(b) / (c) on this rank: POD_STEPS steps of ``train.run`` on the mesh,
    the launch counters zeroed just before and read just after; each leaf
    shard's fingerprint after every step, walls, peak memory."""
    cfg = _family_cfg(arch, layers)
    args = train.parser().parse_args(POD_TRAIN_ARGS + ["--arch", arch]
                                     + flags)
    prints, census, calls, undo = [], {}, [], []

    def on_step(t, state, loss):
        # the second step is held to the census (launch.dryrun): its
        # collectives, the state it leaves and its peak memory
        if t == 1:
            torch.cuda.synchronize()
            census["peak_bytes"] = torch.cuda.max_memory_allocated()
            undo.pop()()
            census["calls"] = list(calls)
            census["held"] = _held_bytes(D, state)
        prints.append(torch.stack([_fingerprint(torch, x) for x in
                                   D.tree_leaves(state.params)]).cpu())
        if t == 0:
            torch.cuda.synchronize()
            census["peak_before"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            undo.append(_count_collectives(calls))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = train.run(args, log=lambda line: None, cfg=cfg, mesh=mesh,
                    on_step=on_step)
    torch.cuda.synchronize()
    counts, by_rows = K.launch_counts(), K.launch_counts_by_rows()
    state = res["state"]
    paths = D._leaf_paths(state.params)
    leaves = D.tree_leaves(state.params)
    expert = [x.numel() for q, x in zip(paths, leaves)
              if q[0] == "moe_layers" and q[-2] == "ffn"
              and q[-1] in ("w_gate", "w_up", "w_down")]
    out = {"coords": mesh.coords, "losses": res["losses"],
           "leaf_numel": [x.numel() for x in leaves],
           "walls_s": res["walls"], "launches": counts,
           "launches_by_rows": by_rows, "n_leaves": len(leaves),
           "local_params": sum(x.numel() for x in leaves),
           "expert_shard_numel": expert, "fingerprints": prints,
           "finite": all(bool(torch.isfinite(x).all()) for x in leaves),
           "census_step": census,
           "peak_gb": max(census.get("peak_before", 0),
                          torch.cuda.max_memory_allocated()) / 2**30,
           "reserved_gb": torch.cuda.max_memory_reserved() / 2**30,
           "params": sum(x.numel() for x in D.tree_leaves(
               M.init_abstract(cfg))), "n_layers": cfg.n_layers}
    del res, state, leaves
    torch.cuda.empty_cache()
    return out


def _pod_rank(rank, world, store, out_dir, full):
    """One rank of phase 11's world of POD_WORLD gloo ranks on cuda:0:
    (a) the parity points, then the full-width points ``full`` (POD_FULL).
    Results go to out_dir/rank<r>.pt; the ranks meet at a barrier before
    they take the group down."""
    import torch
    import torch.distributed as dist

    import repro_torch.configs as configs
    import repro_torch.kernels as K
    from repro_torch.fl import distributed as D
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train
    from repro_torch.models import model as M
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=POD_TIMEOUT_S / 2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {}

    def mesh_of(shape, dev):
        if (shape, dev) not in meshes:
            meshes[(shape, dev)] = MESH.make_mesh(shape, POD_NAMES, dev)
        return meshes[(shape, dev)]

    out = {"a": _pod_parity_rank(torch, D, M, configs, mesh_of)}
    for name, (arch, layers, shape, flags) in full.items():
        out[name] = _pod_full_rank(torch, K, D, M, train, arch, layers,
                                   flags, mesh_of(shape, "cuda"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _pod_gate(torch, D, what, want, got) -> dict:
    """``got`` (a gathered state) against ``want`` at the POD_* gates."""
    flips = n_ef = 0
    moved, worst = [], 0.0
    for field in ("params", "prev_params", "ef"):
        a_tree, b_tree = want[field], got[field]
        check((a_tree is None) == (b_tree is None), f"{what}: {field}")
        if a_tree is None:
            continue
        for q in D._leaf_paths(b_tree):
            a = D._get(a_tree, q).to(torch.float32)
            b = D._get(b_tree, q).to(torch.float32)
            check(a.shape == b.shape, f"{what}: {field} {q} shape")
            if field != "ef":
                rel = float(torch.linalg.vector_norm(a - b)
                            / torch.clamp(torch.linalg.vector_norm(a),
                                          min=1e-30))
                worst = max(worst, rel)
                check(rel <= EXAMPLE_REL_L2, f"{what}: {field} {q} is "
                      f"{rel} apart")
                continue
            flip = ((a == 0) != (b == 0)) | ((a != 0) & (b != 0) & (
                torch.sign(a) != torch.sign(b)))
            flips += int(flip.sum())
            n_ef += a.numel()
            a, b = torch.where(flip, 0.0, a), torch.where(flip, 0.0, b)
            w = D._get(got["prev_params"], q).to(torch.float32).abs()
            ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
            floor = torch.where((a != 0) | (b != 0), POD_ULPS * ulp, 0.0)
            expert = (q[0] == "moe_layers" and q[-2] == "ffn"
                      and q[-1] != "router")
            for sl in (
                    [tuple(i) for i in torch.cartesian_prod(*(
                        torch.arange(n) for n in a.shape[:3])).tolist()]
                    if expert else [()]):
                d = torch.linalg.vector_norm(a[sl] - b[sl])
                lim = (POD_EF_REL * torch.linalg.vector_norm(a[sl])
                       + torch.linalg.vector_norm(floor[sl]))
                if float(d) > float(lim):
                    moved.append(f"{q}{sl}")
    check(flips <= POD_FLIP_MAX, f"{what}: {flips} residual flips")
    check(len(moved) <= POD_MOVED_MAX, f"{what}: residuals beyond the "
          f"bound in {moved}")
    return {"max_leaf_rel_l2": worst, "residual_flips": flips,
            "residual_elements": n_ef, "moved_slices": moved}


def _pod_parity(torch, name, res) -> dict:
    """(a)'s checks on rank 0's gathered states (every rank gathers the
    same): the card's two runs bit-identical; the card against the cpu
    ranks and against the meshless composition on the card."""
    import repro_torch.configs as configs
    from repro_torch.fl import distributed as D
    from repro_torch.models import model as M
    arch, over, shape = POD_PARITY[name]
    c0, c1, cpu = res["cuda0"], res["cuda1"], res["cpu0"]
    check(c0["losses"] == c1["losses"], f"{name}: rerun losses differ")
    for f in ("params", "prev_params", "ef"):
        check(all(torch.equal(x, y) for x, y in zip(
            D.tree_leaves(c0["state"][f]), D.tree_leaves(c1["state"][f]))),
            f"{name}: rerun {f} differ")
    out = {"losses_cuda": c0["losses"], "losses_cpu": cpu["losses"],
           "rerun_bit_identical": True}
    for lg, lc in zip(c0["losses"], cpu["losses"]):
        check(abs(lg - lc) <= EXAMPLE_LOSS_RTOL * abs(lc), f"{name}: loss "
              f"{lg} on the card vs {lc} on the cpu ranks")
    out["vs_cpu"] = _pod_gate(torch, D, f"{name} cuda vs cpu", cpu["state"],
                              c0["state"])
    # the meshless composition, pod by pod on the card
    cfg = dataclasses.replace(configs.get(arch).smoke(), **over)
    dcfg = D.DistConfig(**POD_PARITY_DIST)
    n_pods = shape[0]
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    st = D.init_state(D.tree_map(lambda a: a.to("cuda"), params), dcfg)

    def pods(t):
        return None if t is None else D.tree_map(
            lambda a: a.expand((n_pods,) + tuple(a.shape[1:])).clone(), t)

    st = dataclasses.replace(st, prev_params=pods(st.prev_params),
                             ef=pods(st.ef))
    step = D.make_pods_step(cfg, dcfg, n_pods, device="cuda")
    losses = []
    for b in _pod_batches(torch, cfg):
        st, m = step(st, {k: v.to("cuda") for k, v in b.items()})
        losses.append(float(m["loss"]))
    for lg, lm in zip(c0["losses"], losses):
        check(abs(lg - lm) <= EXAMPLE_LOSS_RTOL * abs(lm), f"{name}: loss "
              f"{lg} on the mesh vs {lm} composed pod by pod")
    out["losses_composed"] = losses
    out["vs_composed"] = _pod_gate(torch, D, f"{name} mesh vs composed",
                                   _state_cpu(D, st), c0["state"])
    return out


def _pod_full_checks(torch, name, ranks, checked_sizes, full) -> dict:
    """(b) / (c)'s checks over every rank's results."""
    from repro_torch.fl import distributed as D
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    arch, layers, shape, flags = full[name]
    cfg = _family_cfg(arch, layers)
    mesh = MESH.abstract_mesh(shape, POD_NAMES)
    specs = D.tree_leaves(M.param_specs(cfg, mesh))
    r0 = ranks[0][name]
    leaves = r0["n_leaves"]
    want = {"magnitude_histogram": 2 * leaves * POD_STEPS,
            "hybrid_compress": leaves * POD_STEPS,
            "recover": leaves * POD_STEPS, "decode_attention": 0}
    for r, res in enumerate(ranks):
        got = res[name]
        check(got["n_leaves"] == leaves and got["launches"] == want,
              f"{name} rank {r}: launches {got['launches']}, want {want}")
        for k, per in got["launches_by_rows"].items():
            check(set(per) <= {1}, f"{name} rank {r}: {k} at rows {per}")
        check(got["losses"] == r0["losses"] and all(
            math.isfinite(x) for x in got["losses"]),
            f"{name} rank {r}: losses {got['losses']} vs {r0['losses']}")
        check(got["finite"], f"{name} rank {r}: a non-finite parameter")
        check(all(n < 2 ** 31 for n in got["expert_shard_numel"]),
              f"{name} rank {r}: an expert shard of 2^31 or more")
    # replicas of one shard (ranks that differ only on axes the leaf's
    # spec does not split) hold the same bits after every step
    for j, sp in enumerate(specs):
        axes = [POD_NAMES.index(a) for a in SH.spec_axes(sp)]
        seen = {}
        for res in ranks:
            got = res[name]
            key = tuple(got["coords"][i] for i in axes)
            fp = [int(p[j]) for p in got["fingerprints"]]
            check(seen.setdefault(key, fp) == fp, f"{name}: leaf {j}'s "
                  f"replicas {key} differ")
    sizes = {n for res in ranks for n in res[name]["leaf_numel"]}
    check(sizes <= set(checked_sizes), f"{name}: a leaf shard's width was "
          "not checked in phase 3c")
    walls = [res[name]["walls_s"] for res in ranks]
    last = max(w[-1] for w in walls)
    tokens = 8 * 128
    return {"arch": arch, "n_layers": cfg.n_layers, "mesh": dict(zip(
        POD_NAMES, shape)), "flags": flags, "params": r0["params"],
        "local_params_per_rank": [res[name]["local_params"]
                                  for res in ranks],
        "leaves": leaves, "losses": r0["losses"],
        "step_walls_s_per_rank": walls, "ms_per_step": last * 1e3,
        "tokens_per_s": tokens / last,
        "peak_gb_per_rank": [res[name]["peak_gb"] for res in ranks],
        "reserved_gb_per_rank": [res[name]["reserved_gb"] for res in ranks],
        "expert_shard_numel": r0["expert_shard_numel"],
        "launches_per_rank": [res[name]["launches"] for res in ranks],
        "census_step_per_rank": [res[name]["census_step"]
                                 for res in ranks]}


def phase_pod_mesh(torch, checked_sizes, full=None) -> dict:
    """Phase 11: Track B over a pod mesh on POD_WORLD gloo ranks sharing
    cuda:0 (`mesh.spawn` of `_pod_rank`; results through
    build/pod_mesh/rank<r>.pt, deleted after). (a) The reference's
    multipod config on (pod 2, data 2, model 1) and Llama-4-Scout's smoke
    config on (1, 2, 2) (experts over "model"), 2 steps: the card's run
    twice bit-identical, against the cpu ranks' and against the meshless
    composition pod by pod on the card at the POD_* gates. (b) Qwen1.5-4B
    at full width and POD_QWEN_LAYERS layers on (2, 2, 1) and (c)
    Llama-4-Scout at full width and depth 1 on (1, 2, 2) (no error
    feedback), POD_STEPS steps each through ``train.run``: per rank the histogram twice and compress
    and recover once per leaf shard and step, at one row; losses finite
    and the same on every rank; every leaf shard's replicas bit-identical
    after every step; every expert shard under 2^31; ms per step (the
    slowest rank), tokens/s, peak memory per rank."""
    from repro_torch.launch import mesh as MESH
    full = full or POD_FULL
    work = os.path.join(ROOT, "build", "pod_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    # four processes share the card: segments that grow in place keep
    # each rank's cached blocks from fragmenting the others' room
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        MESH.spawn(_pod_rank, POD_WORLD,
                   (POD_WORLD, os.path.join(work, "pg"), work, full),
                   timeout_s=POD_TIMEOUT_S)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                 for r in range(POD_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {}
    for name in POD_PARITY:
        out[name] = _pod_parity(torch, name, ranks[0]["a"][name])
        print(f"{name}: " + json.dumps(out[name]))
    for name in full:
        out[name] = _pod_full_checks(torch, name, ranks, checked_sizes,
                                     full)
        print(f"{name}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# Phase 12: serving and prefill under a mesh (ROADMAP item 13c(a))
# ---------------------------------------------------------------------------

SERVE_MESH_NAMES = ("data", "model")
SERVE_MESH_TIMEOUT_S = 600.0
# published widths, bf16, depth cut: (a) the batch over "data" and Qwen's
# 20 kv heads over "model", prompt 4 then 4 greedy tokens (generate's
# 7 steps into an 8-position cache), plus make_prefill on the prompt; (b)
# one row, so the sequence goes over "data" (heads over "model"), its
# cache seeded with 4,094 of 4,096 positions: the second step writes the
# last position, and the two segments' softmax partials are merged across
# ranks; (c) Granite-34B's one kv head does not divide "model", so its
# sequence is split there, a cache seeded with 1,022 of 1,024 positions
SERVE_MESH = {
    "serve_mesh_qwen_batch": dict(arch="qwen1.5-4b", layers=2, shape=(2, 2),
                                  batch=4, seq=8, start=0, prompt=4,
                                  steps=7, seed=0),
    "serve_mesh_qwen_long": dict(arch="qwen1.5-4b", layers=2, shape=(2, 2),
                                 batch=1, seq=4096, start=4094, prompt=1,
                                 steps=2, seed=0),
    "serve_mesh_granite": dict(arch="granite-34b", layers=1, shape=(1, 2),
                               batch=2, seq=1024, start=1022, prompt=1,
                               steps=2, seed=1),
}
SERVE_MESH_LOCAL_STEPS = 3       # (d): the (1, 1) mesh against mesh=None
SERVE_MESH_CENSUS = ("serve_mesh_qwen_batch",)   # its first decode step is
                                                 # held to the census
# (e): kernel 4's lse mode at each point's per-rank shapes: (B, H, Hkv, D,
# S_loc, lengths to check, lengths timed)
LSE_SHAPES = {
    "serve_mesh_qwen_batch": (2, 10, 10, 128, 8, [[0, 1], [5, 8], [7, 3]],
                              [8, 8]),
    "serve_mesh_qwen_long": (1, 10, 10, 128, 2048, [[0], [1], [1000],
                                                    [2047], [2048]], [2048]),
    "serve_mesh_granite": (2, 48, 1, 128, 512, [[0, 7], [511, 512]],
                           [512, 512]),
}
LSE_TOL = 1e-5                   # |lse − plain lse|, both f32


def _serve_rows(torch, b: int, mesh) -> slice:
    """This rank's rows: its block over the data axes when they divide the
    batch, else every row (all rows without a mesh)."""
    if mesh is None:
        return slice(0, b)
    axes = tuple(a for a in mesh.axis_names if a != "model")
    n = mesh.size_over(axes)
    if b % n:
        return slice(0, b)
    r = b // n
    i = mesh.index_over(axes)
    return slice(i * r, (i + 1) * r)


def _serve_mesh_steps(torch, pt, cfg, params, mesh, tokens, dev,
                      steps=None, census_step=None) -> dict:
    """One point through the port's serve entry points: a cache seeded
    from ``pt["seed"]`` at its first ``start`` positions (this rank's
    shards of it under ``mesh``, `launch.specs.shard_cache`), ``steps``
    of ``make_serve_step`` fed ``tokens`` [steps, B, 1] (None: the prompt,
    then the greedy token of the step before), and ``make_prefill`` on a
    prompt of more than one token; the decode kernel's launches counted
    over the steps, the host clock per step (ending at a sync), the
    written positions of the gathered cache and whether the seeded ones
    kept their bits. Step ``census_step`` (on the card) is held to the
    census: its collectives and its peak memory."""
    from repro_torch.fl import distributed as D
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    b, s, start = pt["batch"], pt["seq"], pt["start"]
    steps = steps or pt["steps"]
    gen = torch.Generator(device=dev).manual_seed(pt["seed"] + 100)
    prompt = torch.randint(0, cfg.vocab, (b, pt["prompt"]), generator=gen,
                           device=dev, dtype=torch.int32)
    whole = M.init_cache(cfg, b, s, dev)
    for leaf in D.tree_leaves(whole):
        leaf[:, :, :start].copy_(torch.randn(leaf[:, :, :start].shape,
                                             generator=gen, device=dev))
    seeded = D.tree_map(lambda a: a[:, :, :start].clone(), whole)
    rows = _serve_rows(torch, b, mesh)
    cache = whole if mesh is None else SP.shard_cache(whole, cfg, mesh, b, s)
    del whole
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in D.tree_leaves(cache))
    step = D.make_serve_step(cfg, mesh, dev)
    length = torch.full((b,), start, dtype=torch.int32, device=dev)[rows]
    tok = prompt[:, :1] if tokens is None else tokens[0]
    logits, fed, walls = [], [], []
    census, calls = {}, []
    _sync(torch, dev)
    FA.decode_attention.launches = 0
    with torch.no_grad():
        for i in range(steps):
            if i == census_step:
                census["peak_before"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                undo = _count_collectives(calls)
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tok[rows], length)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            if i == census_step:
                census.update(calls=calls,
                              peak_bytes=torch.cuda.max_memory_allocated())
                undo()
            logits.append(lg.float().cpu())
            fed.append(tok.cpu())
            length = length + 1
            if tokens is not None:
                tok = tokens[min(i + 1, steps - 1)]
            elif i + 1 < pt["prompt"]:
                tok = prompt[:, i + 1:i + 2]
            else:
                tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
        launches = FA.decode_attention.launches
        prefill = None
        if pt["prompt"] > 1:
            prefill = D.make_prefill(cfg, mesh, dev)(
                params, {"tokens": prompt[rows]}).float().cpu()
        whole = cache if mesh is None else SP.gather_cache(cache, mesh)
    untouched = all(torch.equal(a[:, :, :start], w) for a, w in zip(
        D.tree_leaves(whole), D.tree_leaves(seeded)))
    written = [a[:, :, start:start + steps].float().cpu()
               for a in D.tree_leaves(whole)]
    return {"logits": torch.stack(logits), "tokens": torch.stack(fed),
            "walls_s": walls, "launches": launches, "prefill": prefill,
            "written": written, "seeded_untouched": untouched,
            "cache_bytes": cache_bytes, "rows": (rows.start, rows.stop),
            "census_step": census or None}


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _serve_mesh_rank(rank, world, store, out_dir, points, feed_path, dev):
    """One rank of a phase-12 world of gloo ranks sharing ``dev`` (cuda:0):
    every point of ``points`` (name: point with its "cfg") on its mesh,
    this rank holding only its shards of the parameters (`param_specs`)
    and of the cache (`cache_specs`), fed the meshless run's tokens
    (``feed_path``). The plain twin of the decode kernel is counted: the
    mesh path must never take it. Results go to out_dir/rank<r>.pt; the
    ranks meet at a barrier before they take the group down."""
    import torch
    import torch.distributed as dist

    from repro_torch.fl import distributed as D
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.models import model as M
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=SERVE_MESH_TIMEOUT_S / 2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = {"calls": 0}
    twin = FA.decode_attention_plain

    def counted(*args, **kw):
        plain["calls"] += 1
        return twin(*args, **kw)

    FA.decode_attention_plain = counted
    feed = torch.load(feed_path)
    meshes, out = {}, {}
    for name, pt in points.items():
        if pt["shape"] not in meshes:
            meshes[pt["shape"]] = MESH.make_mesh(pt["shape"],
                                                 SERVE_MESH_NAMES, dev)
        mesh = meshes[pt["shape"]]
        cfg = pt["cfg"]
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = M.init_params(cfg, torch.Generator(
            device=mesh.device).manual_seed(pt["seed"]), mesh.device)
        params = SH.shard_tree(params, M.param_specs(cfg, mesh), mesh)
        res = _serve_mesh_steps(
            torch, pt, cfg, params, mesh, feed[name].to(mesh.device),
            mesh.device, census_step=0 if name in SERVE_MESH_CENSUS
            and mesh.device.type == "cuda" else None)
        res.update(coords=mesh.coords, plain_calls=plain["calls"],
                   local_params=sum(x.numel() for x in D.tree_leaves(params)),
                   params_bytes=sum(x.numel() * x.element_size()
                                    for x in D.tree_leaves(params)))
        if mesh.device.type == "cuda":
            res["peak_gb"] = max((res["census_step"] or {}).get(
                "peak_before", 0), torch.cuda.max_memory_allocated()) / 2**30
        if mesh.rank != 0:
            res["written"] = None       # rank 0's gathered cache suffices
        out[name] = res
        del params
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()



def _sdpa_lse(torch, qt, kt, vt, bias):
    """torch's memory-efficient SDPA on [B, Hkv, G, D] queries (each kv
    head's G query heads folded into the query length) against [B, Hkv,
    S, D] keys and values, with an additive length bias [B, Hkv, G, S],
    asked for its log-sum-exp [B, Hkv, ≥ G]: one PyTorch call that
    returns what the lse mode returns."""
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias, True)


def _lse_mode(torch, timer) -> dict:
    """Phase 4b, phase 12's (e): kernel 4's lse mode against its plain twin
    at phase 12's per-rank shapes (LSE_SHAPES), f32 and bf16, run beside
    phase 4 (the profiler windows of the kernels' own time belong before
    the multi-process phases): the output within
    DECODE_TOL, the lse within LSE_TOL (−inf exactly where the plain
    version has it: a row of length 0), the output bit-equal to the call
    without lse; at bf16 also the f32 output the mesh's partials take,
    within f32's DECODE_TOL of the plain version's and rounding to the
    bf16 output bit for bit. Then at bf16 and the timed lengths: ms of the
    mesh's call (lse, f32 output) and of the call without lse, own time
    (one CUDA kernel), the plain twin's ms and SDPA's (`_sdpa_lse`, its
    lse checked against the kernel's), beside the bound (bf16 operations
    at the tensor cores' rate)."""
    from repro_torch.kernels import flash_attention as FA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, (b, h, hkv, d, s, sweeps, timed) in LSE_SHAPES.items():
        res, err32 = {}, 0.0
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen,
                            device=dev).to(dtype)
            tol = DECODE_TOL[dt]
            err = lerr = 0.0
            for lv in sweeps:
                length = torch.tensor(lv, dtype=torch.int32, device=dev)
                lse = torch.empty((b, h), dtype=torch.float32, device=dev)
                plse = torch.empty_like(lse)
                got = FA.decode_attention(q, k, v, length, lse)
                want = FA.decode_attention_plain(q, k, v, length, plse)
                bare = FA.decode_attention(q, k, v, length)
                torch.cuda.synchronize()
                check(torch.equal(got, bare), f"lse {name} {dt} {lv}: the "
                      "output differs from the call without lse")
                diff = (got.float() - want.float()).abs()
                check(bool((diff <= tol + tol * want.float().abs()).all()),
                      f"lse {name} {dt} {lv}: output outside {tol} (max "
                      f"{float(diff.max()):.3g})")
                inf = torch.isinf(plse)
                check(torch.equal(inf, torch.isinf(lse)) and torch.equal(
                    lse[inf], plse[inf]), f"lse {name} {dt} {lv}: -inf "
                    "rows differ")
                ld = (lse[~inf] - plse[~inf]).abs()
                ld = float(ld.max()) if ld.numel() else 0.0
                check(ld <= LSE_TOL, f"lse {name} {dt} {lv}: lse {ld:.3g} "
                      f"from the plain version's (tolerance {LSE_TOL})")
                err, lerr = max(err, float(diff.max())), max(lerr, ld)
                if dt == "bfloat16":
                    lse32 = torch.empty_like(lse)
                    got32 = FA.decode_attention(q, k, v, length, lse32,
                                                torch.float32)
                    want32 = FA.decode_attention_plain(q, k, v, length, None,
                                                       torch.float32)
                    check(torch.equal(got32.to(dtype), bare) and torch.equal(
                        lse32, lse), f"lse {name} {lv}: the f32 output "
                        "does not round to the bf16 one, or its lse differs")
                    t32 = DECODE_TOL["float32"]
                    d32 = (got32 - want32).abs()
                    check(bool((d32 <= t32 + t32 * want32.abs()).all()),
                          f"lse {name} {lv}: f32 output outside {t32} (max "
                          f"{float(d32.max()):.3g})")
                    err32 = max(err32, float(d32.max()))
            res[dt] = {"max_abs_err": err, "lse_max_abs_err": lerr}
        res["bfloat16"]["f32_out_max_abs_err"] = err32
        # timed at bf16 (the phase's dtype), the timed lengths
        length = torch.tensor(timed, dtype=torch.int32, device=dev)
        lse = torch.empty((b, h), dtype=torch.float32, device=dev)
        plse = torch.empty_like(lse)
        f32 = torch.float32

        def call():
            return FA.decode_attention(q, k, v, length, lse, f32)
        res["ms"] = timer.ms(call)
        res["ms_without_lse"] = timer.ms(
            lambda: FA.decode_attention(q, k, v, length))
        own = _kernel_only(torch, timer.flush, call)
        _one_kernel(f"decode_attention lse {name}", own)
        res["kernel_only_ms"] = own["kernel_only_ms"]
        res["plain_ms"] = timer.ms(
            lambda: FA.decode_attention_plain(q, k, v, length, plse, f32))
        g = h // hkv
        qt = q.view(b, hkv, g, d)
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        pos = torch.arange(s, device=dev)[None, None, None, :]
        bias = torch.zeros((b, hkv, g, s), dtype=q.dtype, device=dev)
        bias.masked_fill_(pos >= length[:, None, None, None], float("-inf"))
        call()
        res["library_ms"] = res["library_kernel_only_ms"] = None
        try:
            lib_lse = _sdpa_lse(torch, qt, kt, vt, bias)[1][:, :, :g]
            res["library_lse_max_abs_err"] = float(
                (lib_lse.reshape(b, h) - lse).abs().max())
            res["library_ms"] = timer.ms(
                lambda: _sdpa_lse(torch, qt, kt, vt, bias))
            res["library_kernel_only_ms"] = _kernel_only(
                torch, timer.flush,
                lambda: _sdpa_lse(torch, qt, kt, vt, bias))["kernel_only_ms"]
        except RuntimeError as e:         # a yardstick only
            res["library_note"] = f"SDPA with lse refused: {e}"[:200]
        es = q.element_size()
        valid = sum(min(x, s) for x in timed)
        # q read, the f32 output and lse written, the valid K/V rows read
        bytes_moved = (b * h * d * es + b * h * d * 4 + 2 * valid * hkv * d
                       * es + 4 * b + 4 * b * h)
        res["bound_ms"], res["bound_by"] = _bound(
            bytes_moved, 4.0 * valid * h * d, BF16_FLOPS)
        res["shape"] = (f"q[{b},{h},{d}] kv[{b},{s},{hkv},{d}] bfloat16 "
                        f"lengths {timed}")
        res["plan"] = FA.plan(b, h, hkv, d, s, es, _sm_count(torch))._asdict()
        out[name] = res
        print(f"kernel decode_attention lse {name}: " + json.dumps(res))
    return out


def _serve_mesh_gates(torch, name, pt, base, ranks, smi) -> dict:
    """(a)–(c), (f): every rank's logits of its rows within SERVE_REL_L2 of
    the meshless run at every step and its greedy tokens on at least
    SERVE_ARGMAX_AGREE of them (the prefill too); ranks of one data block
    bit-identical; the decode kernel launched once per attention layer
    and step on every rank and the plain twin never; the seeded positions
    of the gathered cache untouched and the written ones within
    SERVE_REL_L2 of the meshless cache's."""
    layers, steps = pt["cfg"].n_layers, pt["steps"]
    rels, agree, same = [], [], {}
    for r, res in enumerate(ranks):
        what = f"{name} rank {r} {res['coords']}"
        check(res["launches"] == layers * steps, f"{what}: "
              f"{res['launches']} decode kernel launches, want "
              f"{layers * steps}")
        check(res["plain_calls"] == 0, f"{what}: the plain twin ran "
              f"{res['plain_calls']} times")
        check(res["seeded_untouched"], f"{what}: a seeded cache position "
              "changed")
        lo, hi = res["rows"]
        want = base["logits"][:, lo:hi]
        check(torch.equal(res["tokens"], base["tokens"]),
              f"{what}: fed other tokens")
        for i in range(steps):
            rel = _rel_l2(torch, res["logits"][i], want[i])
            check(rel <= SERVE_REL_L2, f"{what}: step {i} logits {rel} "
                  "from the meshless run's")
            rels.append(rel)
        a = float((torch.argmax(res["logits"], -1)
                   == torch.argmax(want, -1)).float().mean())
        check(a >= SERVE_ARGMAX_AGREE, f"{what}: greedy tokens agree on "
              f"{a} of the steps")
        agree.append(a)
        if base["prefill"] is not None:
            rel = _rel_l2(torch, res["prefill"], base["prefill"][lo:hi])
            check(rel <= SERVE_REL_L2, f"{what}: prefill {rel}")
            rels.append(rel)
        key = res["coords"][0]
        if key in same:
            check(torch.equal(res["logits"], same[key]), f"{what}: logits "
                  "differ from another rank of its data block")
        same.setdefault(key, res["logits"])
    cache_rel = max(_rel_l2(torch, a, w) for a, w in zip(
        ranks[0]["written"], base["written"]))
    check(cache_rel <= SERVE_REL_L2, f"{name}: written cache positions "
          f"{cache_rel} from the meshless run's")
    walls = [max(res["walls_s"][i] for res in ranks) for i in range(steps)]
    whole = base["cache_bytes"]
    return {"card": smi, "arch": pt["arch"], "n_layers": layers,
            "mesh": dict(zip(SERVE_MESH_NAMES, pt["shape"])),
            "batch": pt["batch"], "cache_positions": pt["seq"],
            "seeded_positions": pt["start"], "steps": steps,
            "max_logits_rel_l2": max(rels), "greedy_agree_min": min(agree),
            "written_cache_rel_l2": cache_rel,
            "launches_per_rank": [res["launches"] for res in ranks],
            "step_walls_s_slowest_rank": walls,
            "ms_per_step": walls[-1] * 1e3,
            "tokens_per_s": pt["batch"] / walls[-1],
            "meshless_ms_per_step": base["walls_s"][-1] * 1e3,
            "peak_gb_per_rank": [res.get("peak_gb") for res in ranks],
            "cache_bytes_per_rank": [res["cache_bytes"] for res in ranks],
            "cache_bytes_whole": whole,
            "local_params_per_rank": [res["local_params"] for res in ranks],
            "census_step_per_rank": [
                None if res["census_step"] is None else dict(
                    res["census_step"], params_bytes=res["params_bytes"],
                    cache_bytes=res["cache_bytes"]) for res in ranks]}


def phase_serve_mesh(torch, smi) -> dict:
    """Phase 12: serving and prefill under a ("data", "model") mesh of
    gloo ranks sharing cuda:0 (`mesh.spawn` of `_serve_mesh_rank`; results
    through build/serve_mesh/, deleted after; (e), kernel 4's lse mode at
    the points' per-rank shapes, is phase 4b, `_lse_mode`). The meshless
    runs of SERVE_MESH's points
    on the card (greedy tokens, which the ranks are then fed); (d) the
    (1, 1) local mesh bit-identical to mesh=None; then (a), (b) on 4
    ranks and (c) on 2, gated by `_serve_mesh_gates`."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    out = {}
    points = {n: dict(pt, cfg=_family_cfg(pt["arch"], pt["layers"]))
              for n, pt in SERVE_MESH.items()}
    base, params = {}, {}
    for name, pt in points.items():
        key = (pt["arch"], pt["layers"], pt["seed"])
        if key not in params:
            params.clear()
            torch.cuda.empty_cache()
            params[key] = M.init_params(pt["cfg"], torch.Generator(
                device=dev).manual_seed(pt["seed"]), dev)
        base[name] = _serve_mesh_steps(torch, pt, pt["cfg"], params[key],
                                       None, None, dev)
        if name == "serve_mesh_qwen_batch":
            # (d) the (1, 1) local mesh, bit for bit
            feed = base[name]["tokens"][:SERVE_MESH_LOCAL_STEPS].to(dev)
            runs = [_serve_mesh_steps(torch, pt, pt["cfg"], params[key], m,
                                      feed, dev, SERVE_MESH_LOCAL_STEPS)
                    for m in (None, MESH.make_local_mesh("cuda"))]
            check(torch.equal(runs[0]["logits"], runs[1]["logits"])
                  and torch.equal(runs[0]["prefill"], runs[1]["prefill"])
                  and all(torch.equal(a, b) for a, b in zip(
                      runs[0]["written"], runs[1]["written"])),
                  "serve mesh (d): the (1, 1) local mesh is not "
                  "bit-identical to mesh=None")
            out["local_mesh_bit_identical"] = True
    params.clear()
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", "serve_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    feed_path = os.path.join(work, "feed.pt")
    torch.save({n: b["tokens"] for n, b in base.items()}, feed_path)
    ranks = {}
    try:
        for world in sorted({math.prod(pt["shape"])
                             for pt in points.values()}, reverse=True):
            mine = {n: pt for n, pt in points.items()
                    if math.prod(pt["shape"]) == world}
            t0 = time.perf_counter()
            MESH.spawn(_serve_mesh_rank, world,
                       (world, os.path.join(work, f"pg{world}"), work, mine,
                        feed_path, "cuda"), timeout_s=SERVE_MESH_TIMEOUT_S)
            got = [torch.load(os.path.join(work, f"rank{r}.pt"))
                   for r in range(world)]
            for n in mine:
                ranks[n] = [g[n] for g in got]
            out[f"world{world}_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, pt in points.items():
        out[name] = _serve_mesh_gates(torch, name, pt, base[name],
                                      ranks[name], smi)
        print(f"{name}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# Phase 13: the per-rank census on meta (`launch.dryrun`) held to phases
# 11(b) and 12(a), and its host-only production cells; phase 14: the
# exact-quantile operators of `core.compression`, cuda against cpu
# ---------------------------------------------------------------------------

CENSUS_PEAK_RTOL = 0.10          # census peak_bytes against max_memory_allocated
CENSUS_JOIN_S = 600.0            # the worker's wait once phase 12 is done
POD_CELL = dict(kind="train", seq=128, batch=8)    # POD_TRAIN_ARGS' shapes
# phase 13's cells, census only: (arch, depth, cell, mesh shape, axis
# names, DistConfig fields). Qwen1.5-4B on phase 11's (2, 2, 1) at 8
# layers (which fit four ranks on the card) and 12 (which did not)
CENSUS_CELLS = {
    "qwen_train_4k_pod16x16": ("qwen1.5-4b", None, "train_4k", (16, 16),
                               ("data", "model"), {}),
    "qwen_221_L8": ("qwen1.5-4b", 8, POD_CELL, (2, 2, 1), POD_NAMES,
                    {"use_error_feedback": True}),
    "qwen_221_L12": ("qwen1.5-4b", 12, POD_CELL, (2, 2, 1), POD_NAMES,
                     {"use_error_feedback": True}),
    "deepseek_train_4k_pod16x16": ("deepseek-v3-671b", None, "train_4k",
                                   (16, 16), ("data", "model"), {}),
    "deepseek_train_4k_pod2x16x16": ("deepseek-v3-671b", None, "train_4k",
                                     (2, 16, 16), POD_NAMES, {}),
    "deepseek_decode_32k_pod16x16": ("deepseek-v3-671b", None, "decode_32k",
                                     (16, 16), ("data", "model"), {}),
    "deepseek_decode_32k_pod2x16x16": ("deepseek-v3-671b", None,
                                       "decode_32k", (2, 16, 16), POD_NAMES,
                                       {}),
}
# phase 14: the operators at every ratio at n = EXACT_N[0]; past
# torch.quantile's 2^24 limit, the thresholds at EXACT_BIG_RATIOS and the
# operators at EXACT_BIG_OPS (the cpu side, ~6 s a sort, runs in the census
# worker)
EXACT_N = (164134, 2 ** 25 + 3)
EXACT_RATIOS = (0.0, 0.05, 0.3, 0.5, 0.77, 0.999, 1.0)
EXACT_BIG_RATIOS = (0.0, 0.3, 1.0)
EXACT_BIG_OPS = 0.3
EXACT_MEAN_RTOL = 1e-5           # Σ|x| summed in another order


def _count_collectives(calls: list):
    """Wrap `Mesh._parts` and `Mesh.max_axis` (class-wide, in this
    process) so that every collective a mesh runs appends (op, group
    size, operand bytes) to ``calls``, in the census's terms
    (`launch.mesh.CollectiveCensus`); returns the undo."""
    from repro_torch.launch import mesh as MESH
    parts, mx = MESH.Mesh._parts, MESH.Mesh.max_axis

    def _parts(self, x, axes):
        out = parts(self, x, axes)
        if len(out) > 1:
            calls.append(("all-gather", len(out),
                          x.numel() * x.element_size()))
        return out

    def max_axis(self, x, axes):
        live = self.live_axes(axes)
        if live:
            calls.append(("all-reduce", self.size_over(live),
                          x.numel() * x.element_size()))
        return mx(self, x, axes)

    MESH.Mesh._parts, MESH.Mesh.max_axis = _parts, max_axis

    def undo():
        MESH.Mesh._parts, MESH.Mesh.max_axis = parts, mx
    return undo


def _held_bytes(D, state) -> dict:
    """Bytes of a TrainState's fields as a rank holds them."""
    out = {}
    for f in ("params", "prev_params", "ef", "step", "theta_d", "theta_u"):
        v = getattr(state, f)
        leaves = [] if v is None else ([v] if hasattr(v, "numel")
                                       else D.tree_leaves(v))
        out[f] = sum(x.numel() * x.element_size() for x in leaves)
    return out


def _census_jobs() -> dict:
    """name: (arch, depth, cell, mesh shape, names, rank, DistConfig
    fields) — every rank of phase 11's full-width points and of phase
    12(a), then CENSUS_CELLS at rank 0."""
    jobs = {}
    for name, (arch, layers, shape, flags) in POD_FULL.items():
        for r in range(math.prod(shape)):
            jobs[f"{name}/rank{r}"] = (
                arch, layers, POD_CELL, shape, POD_NAMES, r,
                {"use_error_feedback": "--error-feedback" in flags})
    for name in SERVE_MESH_CENSUS:
        pt = SERVE_MESH[name]
        for r in range(math.prod(pt["shape"])):
            jobs[f"{name}/rank{r}"] = (
                pt["arch"], pt["layers"], dict(
                    kind="decode", seq=pt["seq"], batch=pt["batch"]),
                pt["shape"], SERVE_MESH_NAMES, r, {})
    for name, (arch, layers, cell, shape, names, dist) in \
            CENSUS_CELLS.items():
        jobs[name] = (arch, layers, cell, shape, names, 0, dist)
    return jobs


def _exact_input(n: int):
    """Seeded heavy-tailed f32 (with exact zeros) and a stale copy."""
    import numpy as np
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n, dtype=np.float32)
         * np.exp(rng.standard_normal(n, dtype=np.float32)))
    x[::13] = 0.0
    local = x + rng.standard_normal(n, dtype=np.float32) * np.float32(0.3)
    local[::17] = 0.0
    return x, local


def _digest(t) -> str:
    """sha256 of a tensor's bytes (on the host)."""
    import hashlib

    import torch
    t = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _exact_ops(torch, C, x, local, ratios, ops_ratios) -> dict:
    """The exact operators on ``x`` (any device), as digests: the
    thresholds' f32 bits at ``ratios``; at ``ops_ratios`` the mask, kept,
    sign, max_abs and payload bits of hybrid_compress, mean_abs, top-k
    and its bits, and the recovery (mean_abs given: the cpu's)."""
    out = {}
    for r in ratios:
        thr = C.magnitude_threshold(x, r)
        out[f"thr {r}"] = int(thr.view(torch.int32))
    for r in ops_ratios:
        c = C.hybrid_compress(x, r)
        sp, bits = C.topk_sparsify(x, r)
        out[f"ops {r}"] = {
            "mask": _digest(c.mask), "kept": _digest(c.kept),
            "sign": _digest(c.sign), "max_abs": int(c.max_abs.view(
                torch.int32)), "payload_bits": int(c.payload_bits()),
            "mean_abs": float(c.mean_abs), "topk": _digest(sp),
            "topk_bits": int(bits)}
        out[f"compressed {r}"] = c
    return out


def _census_worker(out_dir: str) -> None:
    """Phase 13's worker, a process on the host beside the card's phases:
    every `_census_jobs` job through `launch.dryrun.census` (records with
    the ordered collective calls; the per-op lists dropped), then phase
    14's cpu side at n = EXACT_N[1], written to out_dir as JSON."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.core import compression as C
    from repro_torch.fl import distributed as D
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    out = {}
    for name, (arch, layers, cell, shape, names, rank, dist) in \
            _census_jobs().items():
        cfg = _family_cfg(arch, layers)
        mesh = MESH.census_mesh(shape, names, rank)
        rec = DR.census(cfg, cell, mesh, D.DistConfig(**dist))
        rec["calls"] = [[c["op"], c["group"], c["bytes"]]
                        for c in mesh.census.calls]
        for op in ("all-gather", "all-reduce"):
            rec["collectives"][op].pop("ops")
        out[name] = rec
    with open(os.path.join(out_dir, "census.json"), "w") as f:
        json.dump(out, f)
    x, local = (torch.from_numpy(a) for a in _exact_input(EXACT_N[1]))
    got = _exact_ops(torch, C, x, local, EXACT_BIG_RATIOS, (EXACT_BIG_OPS,))
    c = got.pop(f"compressed {EXACT_BIG_OPS}")
    got["recover"] = _digest(C.hybrid_recover(c, local))
    with open(os.path.join(out_dir, "exact_cpu.json"), "w") as f:
        json.dump(got, f)


def _census_results(proc, out_dir: str) -> dict:
    proc.join(CENSUS_JOIN_S)
    check(not proc.is_alive(), f"the census worker ran past "
          f"{CENSUS_JOIN_S} s after phase 12")
    check(proc.exitcode == 0, f"the census worker failed ({proc.exitcode})")
    with open(os.path.join(out_dir, "census.json")) as f:
        census = json.load(f)
    with open(os.path.join(out_dir, "exact_cpu.json")) as f:
        exact = json.load(f)
    return {"census": census, "exact_cpu": exact}


def _census_gate(what, rec, meas, state: bool) -> dict:
    """One rank's measured step against its census: the collectives in
    order (op, group, bytes), the parameter and state (or cache) bytes,
    and the peak within CENSUS_PEAK_RTOL of max_memory_allocated."""
    got = [list(c) for c in meas["calls"]]
    check(got == rec["calls"], f"{what}: the collectives measured "
          f"({len(got)}) are not the census's ({len(rec['calls'])})")
    rb = rec["rank_bytes"]
    if state:
        held = meas["held"]
        check(held["params"] == rb["params"], f"{what}: params "
              f"{held['params']} B, census {rb['params']}")
        check(sum(held.values()) == rb["state"], f"{what}: state "
              f"{sum(held.values())} B, census {rb['state']}")
    else:
        check(meas["params_bytes"] == rb["params"], f"{what}: params "
              f"{meas['params_bytes']} B, census {rb['params']}")
        check(meas["cache_bytes"] == rb["cache"], f"{what}: cache "
              f"{meas['cache_bytes']} B, census {rb['cache']}")
    peak, want = rec["memory"]["peak_bytes"], meas["peak_bytes"]
    rel = (peak - want) / want
    check(abs(rel) <= CENSUS_PEAK_RTOL, f"{what}: census peak {peak} B, "
          f"measured {want} ({rel:+.3f})")
    return {"collectives": len(got), "received": sum(
        b * (g - 1) for _, g, b in got), "peak_census": peak,
        "peak_measured": want, "peak_rel": rel,
        "params_bytes": rb["params"], "state_bytes": rb["state"],
        "cache_bytes": rb["cache"]}


def _census_summary(rec) -> dict:
    m = rec["memory"]
    return {"peak_bytes": m["peak_bytes"],
            "argument_bytes": m["argument_size_in_bytes"],
            "temp_bytes": m["temp_size_in_bytes"],
            "output_bytes": m["output_size_in_bytes"],
            "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
            "collectives": rec["collectives"]["total"],
            "all_gather_received": rec["collectives"]["all-gather"][
                "received"],
            "rank_bytes": rec["rank_bytes"], "kernels": rec["kernels"],
            "trace_s": rec["trace_s"]}


def phase_census(torch, res, pod, serve_mesh, smi) -> dict:
    """Phase 13: the census worker's records (`_census_worker`) against
    phase 11(b)'s second step on every rank (`_census_gate`: collectives,
    parameter and state bytes, peak) and phase 12(a)'s first decode step
    (collectives, parameter and cache bytes, peak); phase 11(c) is
    printed beside its census, not gated. Then the host-only cells of
    CENSUS_CELLS, Qwen1.5-4B's (2, 2, 1) points as four ranks' peaks
    against the card's memory."""
    census = res["census"]
    out = {"card": smi, "gated": {}, "reported": {}, "cells": {}}
    for name in POD_FULL:
        per = pod[name]["census_step_per_rank"]
        for r, meas in enumerate(per):
            rec = census[f"{name}/rank{r}"]
            if name == "pod_qwen":
                out["gated"][f"{name}/rank{r}"] = _census_gate(
                    f"census {name} rank {r}", rec, meas, True)
            else:
                out["reported"][f"{name}/rank{r}"] = {
                    "calls_equal": [list(c) for c in meas["calls"]]
                    == rec["calls"],
                    "peak_census": rec["memory"]["peak_bytes"],
                    "peak_measured": meas["peak_bytes"],
                    "held": meas["held"], "census": rec["rank_bytes"]}
    for name in SERVE_MESH_CENSUS:
        for r, meas in enumerate(serve_mesh[name]["census_step_per_rank"]):
            out["gated"][f"{name}/rank{r}"] = _census_gate(
                f"census {name} rank {r}", census[f"{name}/rank{r}"], meas,
                False)
    card = torch.cuda.get_device_properties(0).total_memory
    for name in CENSUS_CELLS:
        out["cells"][name] = _census_summary(census[name])
        if name.startswith("qwen_221"):
            four = 4 * census[name]["memory"]["peak_bytes"]
            out["cells"][name].update(four_ranks_peak=four, card_bytes=card,
                                      fits=four <= card)
        print(f"census {name}: " + json.dumps(out["cells"][name]))
    for k, v in list(out["gated"].items()) + list(out["reported"].items()):
        print(f"census {k}: " + json.dumps(v))
    return out


def phase_exact(torch, res) -> dict:
    """Phase 14: the exact-quantile operators of `core.compression`
    (`torch.sort`, any size), cuda against cpu: at n = EXACT_N[0] every
    operator at every ratio, bit-equal (mean_abs within EXACT_MEAN_RTOL;
    the recovery with the cpu's mean_abs), the tree wrappers and error
    feedback; at n = EXACT_N[1] (past torch.quantile's 2^24) the
    thresholds and the operators against the census worker's cpu
    digests."""
    from repro_torch.core import compression as C
    out = {}
    for n in EXACT_N:
        x, local = (torch.from_numpy(a) for a in _exact_input(n))
        small = n == EXACT_N[0]
        ratios = EXACT_RATIOS if small else EXACT_BIG_RATIOS
        ops = EXACT_RATIOS if small else (EXACT_BIG_OPS,)
        t0 = time.perf_counter()
        cuda = _exact_ops(torch, C, x.cuda(), local.cuda(), ratios, ops)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
        cpu = (_exact_ops(torch, C, x, local, ratios, ops) if small
               else dict(res["exact_cpu"]))
        for r in ops:
            cc = cuda.pop(f"compressed {r}")
            if small:
                cp = cpu.pop(f"compressed {r}")
                want = _digest(C.hybrid_recover(cp, local))
                mean = cp.mean_abs
            else:
                want, mean = cpu.pop("recover"), torch.tensor(
                    cpu[f"ops {r}"]["mean_abs"], dtype=torch.float32)
            a, b = cuda[f"ops {r}"]["mean_abs"], cpu[f"ops {r}"]["mean_abs"]
            check(abs(a - b) <= EXACT_MEAN_RTOL * abs(b), f"exact n={n} "
                  f"r={r}: mean_abs {a} on the card, {b} on the cpu")
            cuda[f"ops {r}"]["mean_abs"] = b
            cc = dataclasses.replace(cc, mean_abs=mean.cuda())
            check(_digest(C.hybrid_recover(cc, local.cuda())) == want,
                  f"exact n={n} r={r}: the recovery differs")
        for k, v in cpu.items():
            check(cuda[k] == v, f"exact n={n}: {k} differs on the card")
        out[n] = {"checked": sorted(cpu), "cuda_s": cuda_s}
    # the tree wrappers and error feedback, over a tree with an empty
    # subtree
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn(300, 7, generator=g), "e": None,
            "m": {"b": torch.randn(1000, generator=g)}}
    ef = {"a": torch.randn(300, 7, generator=g) * 0.1, "e": None,
          "m": {"b": torch.randn(1000, generator=g) * 0.1}}
    on = (lambda t: None if t is None else (
        {k: on(v) for k, v in t.items()} if isinstance(t, dict)
        else t.cuda()))
    for fn, args in ((C.tree_topk_sparsify, (tree, 0.35)),
                     (C.ef_compress, (tree, ef, 0.35))):
        want = fn(*args)
        got = fn(*(on(a) if isinstance(a, dict) else a for a in args))
        flat = (lambda o: [t for t in C._tree_leaves(o) if t is not None]
                if isinstance(o, dict) else [o])
        for w, h in zip(want, got):
            for a, b in zip(flat(w), flat(h)):
                check(torch.equal(a, b.cpu()), f"exact {fn.__name__}: "
                      "the card differs from the cpu")
    print("exact operators: " + json.dumps(out))
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import repro_torch.kernels as K
    from repro_torch.core import compression as C
    from repro_torch.core.caesar import CaesarConfig
    from repro_torch.fl.simulation import EF_EXTRA_ARRAYS, SimConfig, Simulator
    from repro_torch.kernels import build

    check(C.auto_chunk(N_PARAMS, 500) == CHUNK and C.auto_chunk(
        N_PARAMS, 500, extra_arrays=EF_EXTRA_ARRAYS) == EF_CHUNK,
          f"the dense HAR point's chunks are not {CHUNK} and {EF_CHUNK} "
          "(with error feedback): RUNGS is out of date")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = build.build()
    print(f"build: {build_s:.2f} s for {len(build.SOURCES)} kernels "
          f"(phase {time.perf_counter() - t0:.2f} s)")
    for name in build.SOURCES:
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or ("spill" in line and "0 bytes spill"
                                         not in line):
                report = line.split(":", 1)[-1].strip()
                print(f"ptxas {name} {entry}: {report}")

    phase_s = {"build": time.perf_counter() - t0}
    # phase 13's census runs on the host beside the card's phases
    census_dir = os.path.join(ROOT, "build", "census")
    shutil.rmtree(census_dir, ignore_errors=True)
    os.makedirs(census_dir)
    census_proc = multiprocessing.get_context("spawn").Process(
        target=_census_worker, args=(census_dir,), daemon=True)
    census_proc.start()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    kres = timed("kernels", phase_kernels, torch, K, _Timer(torch, flush))
    _scratch_zeroed(torch, build, "the kernels phase")
    # the schemes path's shapes: ResNet-18 (rungs 8 and 2 run there) and
    # cnn_cifar, the chunk 8 of both; x per row is ProWD's upload
    wide_timer = _Timer(torch, flush)
    wres = timed("kernels_resnet18", phase_kernels, torch, K, wide_timer,
                 RESNET_PARAMS, (1, 2, 4, 8), (1, 8), (2, 8))
    _scratch_zeroed(torch, build, "the kernels phase at n = 11,164,362")
    cres = timed("kernels_cnn_cifar", phase_kernels, torch, K, wide_timer,
                 CIFAR_PARAMS, (2, 8), (1, 8), (8,))
    _scratch_zeroed(torch, build, "the kernels phase at n = 699,066")
    dres = timed("decode_kernel", phase_decode, torch,
                 _Timer(torch, flush))
    lse_res = timed("decode_lse", _lse_mode, torch,
                    _Timer(torch, flush))
    _scratch_zeroed(torch, build, "the decode kernel phases")
    tb_sizes, tbres = timed("track_b_kernels", phase_track_b_kernels, torch,
                            K, _Timer(torch, flush, **TRACK_B_TIMER))
    _scratch_zeroed(torch, build, "the kernels at the Track-B leaf widths")
    del flush, wide_timer
    torch.cuda.empty_cache()
    parity = timed("parity", phase_parity, torch, SimConfig, Simulator,
                   CaesarConfig)
    modes_parity = timed("modes_parity", phase_modes_parity, torch,
                         SimConfig, Simulator, CaesarConfig)
    twins: dict = {}     # uncapped runs the capped and resumed ones equal
    cfg, counts, by_rows, main_out = timed(
        "round_path", phase_main, torch, K, SimConfig, Simulator,
        CaesarConfig, twins)
    prof = timed("round_profile", phase_profile, torch, cfg, Simulator,
                 main_out["wall_per_round_s"])
    sharded = timed("sharded", phase_sharded, torch, K, SimConfig, Simulator,
                    CaesarConfig, twins, counts, smi)
    modes_path = timed("modes_path", phase_modes_path, torch, K, SimConfig,
                       Simulator, CaesarConfig)
    schemes = timed("schemes_path", phase_schemes, torch, K, SimConfig,
                    Simulator, CaesarConfig)
    schemes_prof = timed(
        "schemes_profile", phase_schemes_profile, torch, SimConfig, Simulator,
        CaesarConfig, {k: v["wall_per_round_s"] for k, v in schemes.items()})
    wire = timed("wire_path", phase_wire_path, torch, K, SimConfig,
                 Simulator, CaesarConfig, twins)
    capped, capped_launches = timed("capped_store", phase_capped, torch, K,
                                    SimConfig, Simulator, CaesarConfig, cfg,
                                    twins)
    resume = timed("resume", phase_resume, torch, SimConfig, Simulator,
                   CaesarConfig, cfg, twins)
    del twins
    analysis = timed("analysis", phase_analysis, torch, K)
    serve_counts, serve = timed("serve_path", phase_serve, torch, K)
    train_out = timed("train_path", phase_train, torch, K, tb_sizes)
    example = timed("train_example", phase_train_example, torch, K, tb_sizes)
    serve_fam = timed("serve_families", phase_serve_families, torch, K)
    train_fam = timed("train_families", phase_train_families, torch, K,
                      tb_sizes)
    pod = timed("pod_mesh", phase_pod_mesh, torch, tb_sizes)
    serve_mesh = timed("serve_mesh", phase_serve_mesh, torch, smi)
    census_res = timed("census_wait", _census_results, census_proc,
                       census_dir)
    census = timed("census", phase_census, torch, census_res, pod,
                   serve_mesh, smi)
    exact = timed("exact_operators", phase_exact, torch, census_res)
    shutil.rmtree(census_dir, ignore_errors=True)
    _scratch_zeroed(torch, build, "the round, schemes, store, serve and "
                    "train paths")

    replaces = {
        "magnitude_histogram": "src/repro/kernels/topk_threshold.py:34",
        "hybrid_compress": "src/repro/kernels/hybrid_compress.py:21",
        "recover": "src/repro/kernels/recover.py:18",
    }
    shape_rows = {"magnitude_histogram": 1, "hybrid_compress": CHUNK,
                  "recover": CHUNK}
    kernels = []
    for name, rows in shape_rows.items():
        r = kres[(name, rows)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{build.SOURCES[name]}",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_only_ms": r["kernel_only_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"[{rows}, {N_PARAMS}]",
            "launches_schemes_path": {k: v["launches"][name]
                                      for k, v in schemes.items()},
            "launches_modes_path": {k: v["launches"][name]
                                    for k, v in modes_path.items()},
            "launches_wire_path": {k: v["launches"][name]
                                   for k, v in wire.items()
                                   if "launches" in v},
            "resnet18": {f"[{r}, {RESNET_PARAMS}]{how}": {
                k: wres[(key, r)][k] for k in (
                    "ms", "kernel_only_ms", "bound_ms", "plain_ms",
                    "library_ms", "max_abs_err")}
                for key, how in ((name, ""),
                                 (name + "_per_row", " x per row"))
                for r in (1, 2, 8) if (key, r) in wres},
            "launches_train_path": train_out["launches"][name],
            "launches_train_families": {
                k: v["launches"][name] for k, v in train_fam.items()
                if "launches" in v},
            "launches_capped_path": {k: v[name]
                                     for k, v in capped_launches.items()},
            "launches_analysis": analysis["launches"][name],
            "track_b": {f"[1, {n}]{how}": {
                k: tbres[n][(key, 1)][k] for k in (
                    "ms", "kernel_only_ms", "bound_ms", "plain_ms",
                    "library_ms", "max_abs_err")}
                for n in tb_sizes
                for key, how in ((name, ""),
                                 (name + "_per_row", " x per row"))
                if (key, 1) in tbres[n]}})
        if name in by_rows:
            kernels[-1]["launches_by_rows"] = by_rows[name]
        kernels[-1]["launches_pod_mesh_per_rank"] = {
            p: [c[name] for c in pod[p]["launches_per_rank"]]
            for p in POD_FULL}
        w4 = sharded["world4_dense"]
        kernels[-1]["launches_sharded_per_rank"] = {
            "launches": w4["launches_per_rank"][name],
            "by_rows_rank0": w4["launches_by_rows_rank0"][name]}
    r = dres["serve"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/"
                  f"{build.SOURCES['decode_attention']}",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": serve_counts["decode_attention"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "kernel_only_ms": r["kernel_only_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"],
        "launches_serve_families": {k: v["launches"]["decode_attention"]
                                    for k, v in serve_fam.items()},
        "launches_serve_mesh_per_rank": {
            k: serve_mesh[k]["launches_per_rank"] for k in SERVE_MESH},
        "lse_mode_shapes": {k: {x: v[x] for x in (
            "shape", "ms", "ms_without_lse", "kernel_only_ms", "plain_ms",
            "library_ms", "library_kernel_only_ms", "bound_ms", "bound_by")}
            | {"max_abs_err": max(v[dt]["max_abs_err"]
                                  for dt in ("float32", "bfloat16")),
               "lse_max_abs_err": max(v[dt]["lse_max_abs_err"]
                                      for dt in ("float32", "bfloat16"))}
            for k, v in lse_res.items()},
        "family_shapes": {k: {x: dres[k][x] for x in (
            "shape", "ms", "kernel_only_ms", "plain_ms", "library_ms",
            "library_kernel_only_ms", "bound_ms", "max_abs_err")}
            for k in ("llama4", "zamba2", "internvl2")}})
    phase_s["total"] = time.perf_counter() - t_start
    print("phase seconds: " + json.dumps(phase_s))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s,
                   "kernels_all_shapes": {f"{k[0]}[rows={k[1]}]": v
                                          for k, v in kres.items()},
                   "kernels_resnet18": {f"{k[0]}[rows={k[1]}]": v
                                        for k, v in wres.items()},
                   "kernels_cnn_cifar": {f"{k[0]}[rows={k[1]}]": v
                                         for k, v in cres.items()},
                   "decode_all_shapes": dres, "decode_lse_mode": lse_res,
                   "parity": parity, "modes_parity": modes_parity,
                   "main": main_out, "profile": prof, "sharded": sharded,
                   "modes_path": modes_path, "wire_path": wire,
                   "schemes": schemes, "schemes_profile": schemes_prof,
                   "serve": serve, "kernels_track_b": {
                       f"{k[0]}[1, {n}]": v for n, r in tbres.items()
                       for k, v in r.items()},
                   "capped_store": capped, "resume": resume,
                   "analysis": analysis,
                   "train_path": train_out, "train_example": example,
                   "serve_families": serve_fam,
                   "train_families": train_fam, "pod_mesh": pod,
                   "serve_mesh": serve_mesh, "census": census,
                   "exact_operators": exact,
                   "phase_s": phase_s, "kernels": kernels},
                  f, indent=1)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
