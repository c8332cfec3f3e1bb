#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check every kernel.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card (sm_90a) and ``nvcc``; without a card, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and prints
no result.

Data: ``repro_torch.data.make_domains(seed=0)`` at the size of the paper's
Office-31 A->W setting (p = 2048 ResNet-50 features, n_S = 2817, n_T = 795),
sigma by the median heuristic, gamma = 1e-2.

Phases (any failed check raises, and the run exits non-zero):
  1. build every kernel of ``src/repro_torch/kernels/csrc`` (one nvcc each);
  2. K4: threefry bits equal to the plain int64 version on the card, Omega
     floats within 8 ULP (gauss and laplace, sigma != 1, seed >= 2^32, e > 0);
  3. K1 (the operand featurize on the tensor cores) at N in {1000, 4096},
     p = 2048, n = 3612 and at a transform request's widths n in {64, 300,
     512} (split over p there where the output tiles are fewer than the
     SMs; ``rff.split_plan``): max abs error <= 2e-5, each timed beside its
     split-TF32 bound and ``torch.matmul(Omega, X)``; K1 with a Cauchy Omega
     (``draw_omega``'s laplace) at N = 1000, n = 3612, timed: within 2e-5 of
     plain, or, where plain itself is past that from the float64 answer,
     no farther from it than plain, and every element within 2e-5 plus
     2^-20 of sum_k |omega_k x_k| / sqrt(N) of plain (the split products'
     rounding where a phase cancels), with the share of phases recomputed
     as fp32's FMA chain counted by the kernel (``counters=``);
  4. fused Gram (K5 regime N = 1000, K6 regime N = 4096; S in {1, 4}, and
     the tensor-core tiles' edges ``FUSED_GRAM_EDGES``: N 65, p 7 and 40,
     n 795, each at the data's sigma and at the slice's own): atol 2e-5 on
     G_H / max|G_H| and on u against the plain version; where an edge
     misses it, the float64 answer from the same Omega must itself be
     beyond 2e-5 of plain on that metric and the kernel no farther from it
     than plain (each edge reports both distances from that answer);
     whether two identical K5 calls agree bit for bit (its k is
     split across blocks with atomic adds; reported, not gated); the Omega
     draws per element of K5 and K6, counted by the kernel; K5 with Cauchy
     draws (laplace) timed, with the share of phases the featurize
     recomputes as fp32's FMA chain and its distance from plain (reported);
  5. operand Gram (K2/K3) at N in {1000, 4096} with Omega from the port's
     ``draw_omega`` and at ``OPERAND_GRAM_EDGES`` (N 65 and 1000, p 7, 40
     and 2048, n 795, each at both sigmas): atol 2e-5 on G_H / max|G_H| and
     on u, under phase 4's float64 rule at an edge; K2 with a Cauchy Omega
     (laplace, N = 1000) under the same gate and rule, timed, with the share
     of phases its featurize recomputes as fp32's FMA chain (the kernel's
     count); seed-fused featurize (K7) at N = 4096 and at
     ``FUSED_K7_EDGES`` (N 65 and 1000, p 7 and 40, n 1 and 795, each at
     both sigmas): atol 2e-5, and its draws per Omega element as the kernel
     counts them (at most ceil(n / 1024)); K7 with laplace draws timed as K5
     is; centered Gram (K8) at 2N in {2000, 8192} on K1's Sigma and at
     ``K8_EDGES`` (K1's Sigma at the data's sigma on 7 and 40 rows: nearly
     constant rows; n 795 and 3611, not multiples of 4; 2N 130 and 2000,
     not multiples of 128): atol 1e-5 on G / max|G|, or, where plain itself
     is past that from the float64 answer, no farther from it than plain
     (each edge reports both distances), G exactly symmetric; whether two
     identical K8 calls agree bit for bit (its k is split across blocks at
     2N = 2000; reported, not gated); the ptxas line (registers, spills) of
     each tensor-core kernel of the ``rff``, ``rff_gram_stream_fused`` and
     ``centered_gram`` libraries (K2/K3, K5-K8) and their HGMMA count
     (``cuobjdump -sass``): no spills, HGMMA present;
  6. small fit: the card's fit equals the CPU plain path's (eigenvalues rtol
     1e-2, subspace projector within 1e-3); ``draw_omega`` (the materialized
     Omega, gauss and laplace, sigma != 1) gives the card the CPU's Omega
     bit for bit;
  7. the main path through the public entry points, each run followed by 16
     transform requests of 64-512 target columns checked against one
     transform of the same columns concatenated; launch counts are zeroed
     just before and read just after each run:
       A  seed-fused, N = 1000, m = 32, S = 1 (K5, K4, K1; K7 for the client
          messages Sigma ell);
       B  seed-fused, N = 4096, m = 8, S = 4 (K6, K4, K1, K7);
       C  w_rf=None, stream, N = 1000, m = 32, eigh (K2, K1);
       D  w_rf=None, stream, N = 4096, m = 8, lobpcg (K3, K1);
       E  dense, N = 1000, m = 32, eigh then cholesky (K1 + K8);
     cross-checks: C and E share Omega and agree (eigenvalues rtol 1e-3); E's
     two solvers agree (rtol 1e-4, subspace cosines above 1 - 1e-4); on D's
     own (G_H, u), the fit's LOBPCG (the reference's stopping rule, a
     residual of eps 10 2N, ~1 % at 2N = 8192) agrees with eigh to within
     that residual, and LOBPCG at lobpcg_tol=1e-9 to rtol 1e-4 with
     cosines above 1 - 1e-3;
  8. K10 (the wire codecs' fake-quant): bit for bit against its plain version
     at the ``K10_CHECK`` shapes (every launch shape of runs F, F64 and FL,
     and ragged ones) for qint8 and qint4; timed on the card (queued behind a
     device-side sleep, so the host's dispatch is not timed; the calls cycle
     through copies of the inputs that overflow the L2 cache) at (5, 1024)
     and (65, 32768);
  9. K9 (the fleet's weighted segment reduce): within 1e-5 x max(1, max|plain|)
     of its plain version at the ``K9_CHECK`` shapes (every launch shape of
     FL, FT and FS, and tests/test_fleet.py:85's ragged ones), zero weights
     exact, and NaN/Inf inputs giving the plain version's non-finite
     positions; timed like K10 at (1024, 32769) and (1024, 1025) into 64
     edges, beside its plain version and torch.matmul of the weighted
     membership;
 10. FedRF-TCA training (paper Alg. 5) through ``FedRFTCATrainer(...).train()``
     and ``.evaluate()`` at the width of ``repro_torch.configs.fedrf_paper``
     (a copy of ``src/repro/configs/fedrf_paper.py``: p = 16, extractor
     (64, 32), N = 512, m = 32, 5 classes, lambda 2, lr 5e-3, T_C = 50) on
     ``make_domains(5, 400, shift=1.2, seed=3)``,
     drop setting III, 50 warm-up rounds then 100 rounds, launch counts zeroed
     just before and read just after each run:
       F    batched engine, wire transport, qint8 (K10 in every round), K = 4;
            the first launch of each shape is kept and held against the plain
            version after the run, bit for bit (F64 and FL too; K9's first
            launches likewise in FT, FL and FS);
       G    F on the serial engine: its byte and message logs must equal F's;
       H    batched and serial, identity float32, every client in every round:
            parameters within 1e-4 (tests/test_round_engine.py:77);
       FT   H batched with ``Topology.singleton(4)`` and ``client_chunk=2``
            (every merge through K9): parameters within 1e-4 of H batched,
            its tier-1 byte and message logs equal to H's;
       R    H's setting, 10 + 50 rounds, NaN corruption of half the moment
            and W_RF uplinks, under each rule: the mean ends non-finite
            (tests/test_robust.py:281), the four robust rules finite;
       F64  F with K = 64 sources (``make_domains(65, 400, ...)``);
       FL   the fleet at scale (benchmarks/bench_fleet.py:113-124): K = 1024
            sources (``make_domains(1025, 400, ...)``), ``Topology.uniform(
            1024, 64)``, ``client_chunk=128``, qint8 on both tiers, 10 + 50
            rounds (round 50 merges the classifiers); server ingress below the
            flat K-uplink figure;
       S    a short check against a reference: 5 + 5 rounds with the seed-fused
            Omega (K4), the card's parameters within 1e-4 of the CPU's;
       FS   S with ``Topology.of_groups([[0, 1], [2, 3]])``, ``client_chunk=2``,
            the trimmed mean and a Byzantine client boosting its uplinks 100x.
            At E = 2 the rule cannot trim the attacker's edge, so the leaves
            grow to tens and rounding differences grow with them: after the
            same warm-up (within 1e-4), each round runs on the card and the
            CPU from the CPU's state and must agree within 1e-4 x
            max(1, max|leaf|); the free runs' divergence is reported beside
            the CPU's own under a 1e-6 perturbation of its start;
 11. K11 (the backbone's flash attention): the ptxas line of each of its
     kernels (registers, spills) and the count of HGMMA (wgmma) instructions
     in its SASS (``cuobjdump -sass``: the bf16 path runs on the tensor
     cores); at the ``K11_CHECK`` shapes (tests/test_kernels.py:164-187's
     sweep in fp32 and bf16, window 0 and 48, causal and not; ragged s = 77
     and 1000; MLA's d 192 / dv 128, d 320 / dv 288 (dv over the grid), d 20
     (rows TMA cannot load) and d 640 (q and K streamed in d-chunks) in both
     dtypes; v at the model's scale (x 60) in bf16; the serve run's (8, 9,
     3, 2048, 64), internlm2-1.8b's (1, 16, 8, 4096, 128) and phase 16's
     prefills (4, 64, 4, 2048, 128, 128) and (4, 16, 16, 2048, 192, 128) in
     bf16) within
     2e-5 of its plain version at fp32 and one bf16 ULP of it at bf16 (plus
     2e-5: near-zero outputs are sums with cancellation; at most 3e-2 of
     max(1, max|plain|)), non-finite positions equal; timed like K10 at the
     serve shape, at hd 128, at deepseek-v2-lite's MLA prefill (1, 16,
     16, 4096, 192, 128) and at phase 16's two prefills, beside its plain
     version and scaled_dot_product_attention, with ``fa.bf16_plan``;
 12. the LM serve path through ``repro_torch.launch.serve.generate``, K11's
     launch count zeroed just before and read just after each run:
       L    smollm-135m (src/repro/configs/smollm_135m.py: 30 layers, d_model
            576, 9 heads / 3 KV heads, hd 64, d_ff 1536, vocab 49152) in bf16,
            weights from ``LM.init(0)``, batch 8, 2048-token prompts (SmolLM's
            context length), 32 tokens, twice (first and warm): K11 once per
            layer per prefill, the first launch held against plain after the
            run (the K11_CHECK gate, unless the float64 exact answer fails
            it too: then no farther from the exact answer than plain),
            tokens in the vocab and logits finite;
       LC   the same model at fp32, batch 2, 128-token prompts, 8 tokens, on
            the card and, feeding the card's tokens, on the CPU from the same
            weights: every step's logits within 1e-3 x max(1, max|logit|), and
            the greedy tokens equal wherever the CPU's top-two gap exceeds it;
       LH   on the card at fp32, a prefill of 128 tokens plus 4 decode steps
            against ``forward`` over 132 (tests/test_models.py:141-161):
            within 1e-4 (prefill) and 1e-3 (decode) of max(1, max|logit|);
 13. the asynchronous runtime through ``repro_torch.fedsim.AsyncScheduler(...).run``
     at phase 10's width, launch counts zeroed just before and read just after
     each run, flush time on the host clock (each ending in ``synchronize``):
       AD   H batched's setting under ``AsyncScheduler``: uniform latencies, no
            churn, buffer = K = 4, 50 warm-up rounds then 100 flushes: every
            flush a full buffer at staleness 0, the parameters within 1e-4 x
            max(1, max|leaf|) of phase 10's H batched run;
       AQ   F's setting (qint8 over the wire, K = 4) asynchronous: heterogeneous
            links (one slow straggler; 10 % losses, retried), Markov churn at
            an offline fraction of 0.2 (benchmarks/bench_async.py), buffer 2,
            polynomial staleness weights, an eval tick every 10 virtual s, 100
            flushes; K10 at every dispatch and flush, its first launch of each
            shape held against plain bit for bit;
       AC   AQ for 10 flushes from one start (a CPU warm-up, checkpointed and
            restored on each device) on the card and on the CPU, the card
            drawing the CPU's channel uniforms: the histories (times, members,
            staleness, weights) equal, the parameters within 1e-4 x max(1,
            max|leaf|), or, where a qint8 bin flipped, every entry within one
            quantization step and 99 % within that (Omega seed-fused, K4, as
            in S); then the same over an identity float32 wire, held to 1e-4
            x max(1, max|leaf|) alone;
       AC-mat AC with the default materialized Omega (``draw_omega``, one
            draw on every device) under AC's gates, Omega equal bit for bit;
       AL   FL's fleet asynchronous: K = 1024 over ``Topology.uniform(1024,
            64)``, chunk 128, qint8 on both tiers, a buffer of 16 per edge, the
            merged edge uplinks over ``edge_links``, 10 warm-up rounds, 64
            server flushes, an edge crash and a server crash restored from the
            last checkpoint: finite parameters, one recovery, ingress below the
            flat K-uplink figure, K9 and K10 launched, their first launches
            held against plain;
 14. the aligner server through ``repro_torch.serve.AlignerServer`` at fit A's
     width (N = 1000, m = 32, S = 1, seed-fused, sigma by the median
     heuristic, gamma = 1e-2) on four pairs ``make_domains(2, 2817, dim=2048,
     seed=s)``, s in 0..3, each target cut to 795 columns (requests take the
     columns past them), launch counts zeroed just before and read just after
     each run:
       SV   ``AlignerServer(capacity=3, min_bucket=8, max_bucket=512)``: four
            pairs for three slots, so LRU misses refit in the request path;
            ``run_open_loop`` at 250, 1000 and 4000 requests/s
            (benchmarks/bench_serve.py), 400 transform requests of 4-64
            columns a level: every served output within 1e-5 of max|whole| of
            W_RF^T times K1's plain version on its columns, by the state that
            served it (so K1 at each bucket width is held to plain), each bucket's
            plane one sentinel signature over the warm-up and the levels, K1
            once per dispatch (and once per refit: the target mean), K4 once
            per pair (the transform Omega's memo); latency p50 / p99,
            throughput, requests per dispatch, buckets, hit rate, refits;
       SM   a new target device admitted over ``WireTransport`` (float32 and
            qint8): no version change, no refit, its transforms within 1e-3 of
            a from-scratch refit over float32; over qint8 its W_RF within one
            quantization step of the served one and its transforms within a
            step times sum_k |sigma_k(x)| plus 1e-3;
       SD   bench_serve.py's drift monitor (alpha 0.15, window 4, k 2) on 200
            calm then 110 shifted requests (every coordinate + 3 standard
            deviations) of 8-24 columns at 800 requests/s: the first fire
            after the shift, each fire one ``refresh_from_moments`` and one
            version bump (bench_serve.py's contract), at most two fires, a
            second one within SD_REFIRE_EVALS evaluations of the first (the
            first refresh pools batches from before the shift; the second
            pools only shifted ones), the drifted target's discrepancy lower
            under the refreshed aligner than the stale one; detection latency
            and the fires;
       SO   two servers behind one fitted state, telemetry off and on
            (``RequestTracer(rate=0.1)``, an ``SloEngine``, the drift monitor's
            probed planes), 96-224 columns at 400 requests/s: outputs equal
            bit for bit; the wall-clock overhead ratio (reported);
       HP   phase 10's H batched for 10 rounds with ``probe=True`` against
            the same rounds without: parameters bit for bit, ``engine.round``
            one signature, ``last_probes`` finite;
 15. training, with K11's backward K11b:
       K11b its ptxas lines and HGMMA count (raises on none: bf16 runs on
            wgmma); at the K11_CHECK shapes (phase 11's) and K11_LARGE_V's
            bf16 causal with v x 60, the forward's lse within 2e-5 of
            plain's and dq, dk, dv within 1e-4 x max(1, max|plain|) of
            autograd through the plain forward on the fp32 inputs (fp32),
            plus one bf16 ULP of it (bf16), the worst gate units reported;
            at smollm-135m's and internlm2-1.8b's training shapes two
            launches on the same inputs bit for bit, timed beside the plain
            backward and scaled_dot_product_attention's backward, and K11's
            forward with and without the lse store;
       T    smollm-135m as src/repro/configs/smollm_135m.py gives it (30
            layers, bf16, remat, the FDA head N = 512, m = 64, lambda 0.1)
            through ``launch.train.build_train_step``: TokenStream(49152, 8,
            2048, seed=1), 2 clients, AdamW(cosine(3e-4, 10, 30), wd 0.01),
            clip 1, 30 steps: loss, ce and mmd finite, the last 10 steps'
            mean loss below the first 10's + 0.5 (tests/test_launch.py:55),
            K11 60 launches a step (remat runs each forward twice) and K11b
            30, Omega's gradient 0 and W_RF's not; step p50 / p99, tokens/s,
            peak memory;
       TC   its width at 2 layers, fp32, 2 x 128 tokens: one step's loss, ce,
            mmd and every gradient leaf, card against CPU from one state,
            within 1e-4 x max(1, max|leaf|) plus four times what a 1e-7
            relative nudge of the weights moves the CPU's own gradient (the
            random-init stack is ill-conditioned in fp32);
       BL   tests/test_baselines.py's suite (make_domains(3, 250, shift=1.0,
            seed=5)) on the card and the CPU from one start: TCA, R-TCA,
            CORAL, JDA equal; source-only, RF-TCA, DaNN, FedAvg within 0.02;
            all in [0, 1], TCA above 5-class chance + 0.05; then RF-TCA at
            phase 7's Office-31 width (N = 1000, m = 32), K1 and K2 counted;
 16. the MoE family (src/repro/configs/qwen3_moe_235b_a22b.py,
     deepseek_v2_lite_16b.py), K11's launch count zeroed just before and read
     just after each run:
       Q    qwen3-moe-235b-a22b at full width (d_model 4096, 64 heads over 4
            KV heads, hd 128, 128 experts top-8, expert d_ff 1536, vocab
            151936) with 4 of its 94 layers (94 layers of 4.6 GiB do not fit
            one card), bf16, ``LM.init(0)``, 4 x 2048-token prompts, 16 tokens
            through ``serve.generate``, twice (first, warm): K11 once per layer
            at (4, 64, 4, 2048, 128, 128), the first launch held as L's is,
            tokens in the vocab, finite logits; the host draw's seconds, the
            card's own prefill and decode step times, peak memory;
       DS   deepseek-v2-lite-16b whole (27 layers, d_model 2048, 16 MLA heads,
            kv_lora 512, rope 64, 64 routed experts top-6 + 2 shared, d_ff
            1408, vocab 102400; 16.21 G parameters), as Q, after Q's weights
            are freed: K11 at (4, 16, 16, 2048, 192, 128);
       QC, DC one block at fp32 (QC's experts cut to 16, top-8 kept), card
            against CPU from one state over 2 x 128 tokens and 4 decode steps
            from the CPU's cache: the routing first (the top k in order and
            the pairs kept), a token exempt only where it differs at a
            near-tie on the CPU (k-th and (k+1)-th probabilities within 1e-6,
            counted), then outputs and cache columns within 1e-3 x max(1,
            max|x|);
       QH, DH the same blocks on the card: a prefill of 128 tokens and 4
            decode steps against the forward over 132 (tests/test_models.py:
            141-158), 1e-4 and 1e-3 of max(1, max|x|), at a capacity factor
            of E / k (no pair dropped, as tests/test_models.py:113-121 runs
            at 8.0: forward drops pairs that decode keeps);
       DP   ``federated.distributed``'s round at world size 1, NCCL on the card
            and gloo on the CPU (one ``cpu:gloo,cuda:nccl`` group), 5 rounds
            from one start at fedrf_paper's width: within 1e-4 x max(1,
            max|leaf|).  At one rank the all-reduces are identities, so DP
            checks the round's arithmetic on the card, not the exchange
            between ranks;
 17. the runs line, the kernels line (times, bounds (K1-K3, K5-K8 with
     both their fp32 and split-TF32 bounds), plain and library times,
     launches, K1, K4 and K5 with the serve runs' launches by run), the
     card's name and power limit, and the result line.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

P, N_S, N_T, GAMMA, SEED = 2048, 2817, 795, 1e-2, 0
OMEGA_ULP = 8
RFF_ATOL = 2e-5  # tests/test_kernels.py:13
GRAM_ATOL = 2e-5  # tests/test_kernels.py:57, on G_H / max|G_H| and on u
CENTERED_ATOL = 1e-5  # tests/test_kernels.py:41, on G / max|G|
# tests/test_streaming_solver.py:102-105, :52-56, :66-70
MODES_RTOL, CHOL_RTOL, CHOL_COS, LOBPCG_RTOL, LOBPCG_COS = 1e-3, 1e-4, 1e-4, 1e-4, 1e-3
LOBPCG_TIGHT_TOL = 1e-9  # residual under 1e-9 * 10 * 2N (|Ax| + theta): ~8e-5 at 2N = 8192
# H100 SXM datasheet peaks: fp32 outside the tensor cores (an FMA counts 2)
# and HBM3.  INT32 issues on 64 lanes per SM against fp32's 128, so integer ops
# run at a quarter of the fp32 FLOP rate.  The float transform of each draw
# (log1p, sqrt, cos or tan) is not counted: K4's bound is a loose lower figure.
PEAK_FLOPS = 67e12
PEAK_INT_OPS = PEAK_FLOPS / 4
# fp32-accurate products on the tf32 tensor cores (495 TFLOP/s dense) as
# three products each: the rate K5-K7 run at, and the least time for any fp32
# product kernel's work (K1-K3, K5-K8 report it beside their fp32 bound)
PEAK_SPLIT_TF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
THREEFRY_INT_OPS = 82  # 20 rounds x (add, rotate, xor) + 5 key injections x 4 + 2
# K1 at a transform request's widths: phase 7's requests (64-512 columns) and
# every bucket width of phase 14's serving (8-512), each with its own split plan
K1_REQUEST_COLS = (8, 16, 32, 64, 128, 256, 300, 512)
# the tensor-core featurize / Gram tiles' edges on the data: (N, p, n) for K7,
# (N, S, p, n) for K5/K6 (N past a 128-feature block, p under and over a
# k-tile of 32, n ragged (copied to a multiple of 4 for TMA) and n = 1), each
# at the full data's sigma and at the slice's own median-heuristic sigma, as
# a fit of the slice would take it.  With the data's sigma of 28 on 7 or 40
# rows the phases stay under 1 and G_H is a cancellation of G_cc where plain
# itself is ~1.8e-5 (40 rows) from the float64 answer: there the kernel is
# held to be no farther from that answer than plain
FUSED_K7_EDGES = ((65, 7, 1), (65, 40, 795), (1000, 2048, 795), (1000, 40, 1))
FUSED_GRAM_EDGES = ((65, 1, 40, 795), (1000, 4, 7, 795), (65, 4, 2048, 795))
# the same edges on the operand path (K2/K3, S = 1): (N, p, n), Omega from
# draw_omega at each sigma (its rows of p = 7 copied with zero columns for TMA)
OPERAND_GRAM_EDGES = ((65, 40, 795), (1000, 7, 795), (65, 2048, 795))
# K8 on K1's Sigma at the data's sigma (28) on 7 rows: phases under ~0.2,
# nearly constant rows; n not a multiple of 4 (Sigma copied for TMA) and 2N
# not a multiple of 128: (N, p, n), n past N_T taken from x
K8_EDGES = ((65, 7, 795), (1000, 7, 795), (1000, 7, 3611), (65, 40, 795))
# F's launch shapes at K = 4, F64's at K = 64 and FL's at K = 1024 with its
# 64 edge uplinks (downlink, moments, W_RF, classifier w and b), and ragged ones
K10_CHECK = ((1, 1024), (4, 1024), (5, 32768), (4, 160), (4, 5), (64, 1024), (65, 32768),
             (64, 160), (64, 5), (1024, 1024), (1025, 32768), (1024, 160), (1024, 5),
             (64, 32768), (7, 13))
K10_TIMED = ((5, 1024), (65, 32768))  # K + 1 moment rows; K + 1 W_RF rows at K = 64
L2_FLUSH_BYTES = 4 * 50 * 2**20  # four times the H100's 50 MiB L2
FED_WARMUP, FED_ROUNDS, FED_LEAF_TOL = 50, 100, 1e-4
# K9: every launch shape of FL (K = 1024 into 64 edges) and FS / FT (K = 4
# into 2 and 4 edges): moments 2N + 1, W_RF 2N m + 1, classifier w and b
# (+ 1: the hierarchy's ones column), and tests/test_fleet.py:85's ragged ones
# FL: the fleet at the scale of benchmarks/bench_fleet.py:113-124
FL_K, FL_EDGES, FL_CHUNK, FL_WARMUP, FL_ROUNDS = 1024, 64, 128, 10, 50
K9_CHECK = tuple((k, d, e) for k, e in ((FL_K, FL_EDGES), (4, 2), (4, 4))
                 for d in (1025, 32769, 161, 6)) + ((8, 16, 3), (130, 70, 5), (1, 5, 1))
K9_TIMED = ((FL_K, 32769, FL_EDGES), (FL_K, 1025, FL_EDGES))  # FL's W_RF and moment merges
K9_RTOL = 1e-5  # on |kernel - plain| / max(1, max|plain|)
R_WARMUP, R_ROUNDS = 10, 50
# phase 13, the async runtime: AD (degeneracy against H), AQ (lossy links and
# churn at an offline fraction of 0.2, benchmarks/bench_async.py), AC (AQ on
# the card and the CPU from one start), AL (FL's fleet with per-edge buffers)
AQ_FLUSHES, AQ_BUFFER, AQ_EVAL_S, AQ_HORIZON_S = 100, 2, 10.0, 2000.0
AC_WARMUP, AC_FLUSHES = 5, 10
AL_FLUSHES, AL_BUFFER, AL_CKPT_S, AL_CRASH_S, AL_EDGE_CRASH = 64, 16, 1.9, 2.05, (1.55, 5)
ROBUST_RULES = ("mean", "finite_mean", "trimmed_mean", "geomedian", "norm_clip")
# K11: tests/test_kernels.py:164-187's sweep (fp32 and bf16, window 0 and 48,
# causal and not), ragged s, the serve run's shape and internlm2-1.8b's head
# shape (src/repro/configs/internlm2_1p8b.py: 16 heads, 8 KV heads, hd 128)
K11_SWEEP = ((1, 2, 1, 128, 32, 32), (2, 4, 2, 128, 16, 16), (1, 4, 4, 256, 32, 16),
             (2, 8, 2, 64, 64, 64))
LM_ARCH, L_BATCH, L_PROMPT, L_GEN = "smollm-135m", 8, 2048, 32  # SmolLM's context: 2048
K11_SERVE = (L_BATCH, 9, 3, L_PROMPT, 64, 64)  # smollm-135m: 9 heads, 3 KV heads, hd 64
K11_HD128 = (1, 16, 8, 4096, 128, 128)
# deepseek-v2-lite's MLA prefill (src/repro/configs/deepseek_v2_lite_16b.py:
# 16 heads, d = 128 + 64 rope, dv 128; src/repro/models/attention.py:248-261)
K11_MLA = (1, 16, 16, 4096, 192, 128)
# phase 16's prefills: qwen3-moe-235b-a22b's GQA (64 heads over 4 KV heads, g
# = 16, hd 128) and deepseek-v2-lite-16b's MLA (16 heads, d = 128 + 64 rope,
# dv 128), 4 x 2048-token prompts
M_BATCH, M_PROMPT, M_GEN = 4, 2048, 16
K11_Q = (M_BATCH, 64, 4, M_PROMPT, 128, 128)
K11_DS = (M_BATCH, 16, 16, M_PROMPT, 192, 128)
# head widths past the FFMA tile: MLA's, d past one fp32 chunk with dv over
# the grid, rows TMA cannot load (40 bytes), d streamed through the bf16 ring
K11_WIDE = ((1, 4, 4, 256, 192, 128), (1, 2, 1, 100, 320, 288), (1, 2, 1, 100, 20, 12),
            (1, 2, 1, 200, 640, 64))
# v at the scale of smollm-135m's prefill activations (|v| ~ 60), bf16 causal
K11_LARGE_V, K11_V_SCALE = ((2, 4, 2, 512, 64, 64), (1, 4, 2, 256, 128, 128)), 60.0
K11_CHECK = tuple(
    (*shape, dtype, causal, window) for shape in K11_SWEEP + K11_WIDE
    for dtype in ("float32", "bfloat16") for causal in (True, False)
    for window in (0, 48)) + tuple(
    (*shape, dtype, True, window) for shape in ((2, 9, 3, 77, 64, 64), (1, 9, 3, 1000, 64, 64))
    for dtype in ("float32", "bfloat16") for window in (0, 48)) + (
    (*K11_SERVE, "bfloat16", True, 0), (*K11_HD128, "bfloat16", True, 0),
    (*K11_Q, "bfloat16", True, 0), (*K11_DS, "bfloat16", True, 0))
K11_F32_ATOL, K11_BF16_ATOL = 2e-5, 3e-2  # tests/test_kernels.py:174-177
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
# LC: card against CPU at fp32; LH: the prefill -> decode handoff
# (tests/test_models.py:141-161), both from LC's weights
LC_BATCH, LC_PROMPT, LC_GEN, LC_RTOL = 2, 128, 8, 1e-3
LH_EXTRA, LH_PREFILL_RTOL, LH_DECODE_RTOL = 4, 1e-4, 1e-3
# torch.cuda._sleep spins cycles: 5e9 a second outlasts the host by 2.5x at
# the H100's highest clock (1.98 GHz)
SLEEP_CYCLES_PER_S = 5e9
# phase 14, the aligner server at fit A's width (benchmarks/bench_serve.py's
# rates, request mix and drift monitor): four domain pairs for three store
# slots, so LRU misses refit in the request path
SV_PAIRS, SV_CAPACITY, SV_BUCKETS = 4, 3, (8, 512)
SV_RATES, SV_REQUESTS, SV_COLS = (250.0, 1000.0, 4000.0), 400, (4, 64)
SV_FIT = dict(n_features=1000, m=32, ensemble=1)
SERVE_REQ_RTOL = 1e-5  # phase 7's request gate, on max|whole|
ADMIT_ATOL = 1e-3  # benchmarks/bench_serve.py's admission gate (float32 downlink)
SD_CALM, SD_SHIFTED, SD_COLS, SD_RATE = 200, 110, (8, 24), 800.0
# the drift: every coordinate moved by 3 of its standard deviations, as the
# bench's requests move from +0.9 to +3.9 on unit-variance data
SD_SHIFT_STD = 3.0
# SD's monitor (bench_serve.py's): after a refresh re-pins the reference it
# discards SD_BURNIN evaluations and fires after k = 2 more above threshold, so
# a second fire comes 4 evaluations after the first at the earliest; it must
# come within two such spans, and no third fire is allowed
SD_BURNIN, SD_MAX_FIRES, SD_REFIRE_EVALS = 2, 2, 8
SO_REQUESTS, SO_DEGENERACY, SO_COLS, SO_RATE, SO_PAIRS, SO_SAMPLE = 40, 16, (96, 224), 400.0, 7, 0.1
HP_ROUNDS = 10
# phase 15, training: K11b at phase 11's K11_CHECK shapes (the sweep, the wide
# head widths, ragged s, smollm-135m's and internlm2-1.8b's shapes) and at
# K11_LARGE_V's with v x 60, timed at the two training shapes; T (smollm-135m
# as its config gives it: 30 layers, bf16, remat, the FDA head N = 512, m =
# 64, lambda 0.1) on
# TokenStream(49152, 8, 2048, seed=1) with 2 clients, AdamW(cosine(3e-4,
# warmup 10, total 30), wd 0.01), clip 1.0, 30 steps; TC (its width at 2
# layers, fp32, 2 x 128 tokens, card vs CPU); BL (tests/test_baselines.py's
# suite on the card and the CPU, RF-TCA at phase 7's width)
K11B_TIMED = (K11_SERVE, K11_HD128)
K11B_RTOL, K11B_LSE_ATOL = 1e-4, 2e-5  # on max(1, max|plain|); lse absolute
T_BATCH, T_SEQ, T_CLIENTS, T_STEPS, T_LR, T_WARMUP = 8, 2048, 2, 30, 3e-4, 10
TC_LAYERS, TC_BATCH, TC_SEQ, TC_RTOL = 2, 2, 128, 1e-4
BL_MLP_ATOL = 0.02  # MLP-trained accuracies, card vs CPU
BL_WIDE_N, BL_WIDE_M = 1000, 32
# phase 16, the MoE family (src/repro/configs/qwen3_moe_235b_a22b.py and
# deepseek_v2_lite_16b.py): Q at full width with 4 of its 94 layers (a layer
# is 2.49 G parameters, 4.6 GiB in bf16: 94 do not fit one card), DS whole
# (27 layers, 16.21 G parameters); bf16, LM.init(0), 4 x 2048-token prompts,
# 16 tokens through serve.generate, twice.  QC / DC: one block at fp32, card
# against CPU from one state over 2 x 128 tokens and 4 decode steps (QC's
# experts cut to 16 of 128, top-8 kept: one qwen3 block with all 128 is 9.3
# GiB of fp32 on the host); a token whose routing differs is exempt only
# where the CPU's k-th and (k+1)-th probabilities are within MC_TIE.  QH / DH:
# the same blocks' prefill of 128 tokens and 4 decode steps against their
# forward over 132 on the card (tests/test_models.py:141-158), at a capacity
# factor of E / k, where no pair can be dropped (a dropped pair in forward's
# buffer is kept by decode's; tests/test_models.py:113-121 runs at 8.0).  DP:
# the sharded FedRF-TCA round at world size 1 on NCCL (card) and gloo (CPU)
# from one start at fedrf_paper's width, within the round engine's 1e-4
Q_ARCH, Q_LAYERS, DS_ARCH = "qwen3-moe-235b-a22b", 4, "deepseek-v2-lite-16b"
QC_EXPERTS, MC_BATCH, MC_PROMPT, MC_EXTRA, MC_RTOL, MC_TIE = 16, 2, 128, 4, 1e-3, 1e-6
DP_ROUNDS, DP_BATCH, DP_RTOL = 5, 64, 1e-4


def log(*a) -> None:
    print(*a, flush=True)


def timed(torch, fn, reps: int) -> dict:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events, after a warm-up.

    The runs are queued behind a device-side sleep longer than the host takes
    to enqueue them, so the events time the card's work back to back and not
    the host's dispatch.  ``host_ms`` is the host's enqueue time per call;
    ``queued`` is False when the sleep ended before the host was done (``fn``
    synchronizes, or the launch queue filled): ``ms`` then includes host gaps.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(host_s * SLEEP_CYCLES_PER_S, 1e6)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / reps, host_ms=host_s * 1e3 / reps, queued=queued)


def cuda_ms(torch, fn, reps: int) -> float:
    return timed(torch, fn, reps)["ms"]


def ulps(torch, a, b) -> float:
    a, b = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs()).float()
    spacing = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).double()
    return float(((a - b).abs() / spacing).max())


def bound_ms(flops: float, nbytes: float, int_ops: float = 0.0,
             peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    t_ops = (flops / peak_flops + int_ops / PEAK_INT_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bounds(flops: float, nbytes: float, int_ops: float = 0.0) -> dict:
    """An fp32 product kernel's two bounds: its operations at the fp32 FFMA
    rate and at the split-TF32 rate (three tf32 products a product)."""
    fp32, _ = bound_ms(flops, nbytes, int_ops)
    tc, _ = bound_ms(flops, nbytes, int_ops, peak_flops=PEAK_SPLIT_TF32_FLOPS)
    return dict(bound_fp32_ms=fp32, bound_split_tf32_ms=tc)


def ptxas_entries(log_text: str, names=("",)) -> list[str]:
    """The ptxas lines (registers, spills) of the kernels whose mangled names
    contain one of ``names`` (by default every kernel), one line a kernel."""
    out, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if any(k in name for k in names) else None
            if cur:
                out.append(cur)
        elif cur and ("spill" in line or "registers" in line):
            out[-1] += " | " + line.split(":", 1)[-1].strip()
    return out


def serve_phase(torch, dev, doms0, counters, fed) -> tuple[dict, dict]:
    """Phase 14: the aligner server (``repro_torch.serve``) and the telemetry
    (``repro_torch.obs``) on ``dev`` through their entry points; returns
    (runs, cross).  ``doms0`` is phase 7's pair (seed 0), ``counters`` the
    kernels' launch counters, ``fed`` phase 10's trainer settings."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.comm.transport import WireTransport, resolve_codecs
    from repro_torch.core import rf_tca
    from repro_torch.core.kernels_math import median_sigma
    from repro_torch.core.rff import rff_features
    from repro_torch.data import make_domains
    from repro_torch.kernels import prng, rff
    from repro_torch.obs import sentinel
    from repro_torch.serve import AlignerServer, Request, poisson_arrivals, run_open_loop

    runs, cross = {}, {}
    t_phase = time.perf_counter()

    def zero():
        for c in counters.values():
            for k in c:
                c[k] = 0

    def launches():
        return {k: dict(c) for k, c in counters.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # four (source, target) pairs at the Office-31 A->W size; requests take
    # columns of each target's distribution that its fit did not see
    pairs = {}
    for s in range(SV_PAIRS):
        d = doms0 if s == SEED else make_domains(2, N_S, dim=P, seed=s)
        xs = torch.tensor(np.ascontiguousarray(d[0].x), device=dev)
        xt = torch.tensor(np.ascontiguousarray(d[1].x[:, :N_T]), device=dev)
        held = np.ascontiguousarray(d[1].x[:, N_T:])
        fit_kw = dict(SV_FIT, gamma=GAMMA, sigma=median_sigma(torch.cat([xs, xt], dim=1)),
                      seed=SEED)
        pairs[("src", f"tgt{s}")] = (xs, xt, held, fit_kw)
    keys = list(pairs)
    log(f"[serve] {len(pairs)} pairs of p={P} n_S={N_S} n_T={N_T} ("
        f"{time.perf_counter() - t_phase:.1f} s)")
    rng = np.random.default_rng(SEED + 14)

    def requests(n, cols, pool=None, offset=0.0):
        out = []
        for _ in range(n):
            key = keys[int(rng.integers(len(keys)))] if pool is None else pool
            held = pairs[key][2]
            c = rng.choice(held.shape[1] - 40, size=int(rng.integers(cols[0], cols[1] + 1)),
                           replace=False)
            out.append(Request(x=np.ascontiguousarray(held[:, c] + offset), key=key))
        return out

    def recorder(srv):
        """Every served (request, state, output) of ``srv`` from here on."""
        served, dispatch = [], srv.dispatcher._dispatch

        def recording(entry, batch):
            outs = dispatch(entry, batch)
            served.extend((r, entry.state, o) for r, o in zip(batch, outs))
            return outs

        srv.dispatcher._dispatch = recording
        return served

    def check_served(tag, served):
        """Each output against W_RF^T of K1's plain version on its columns,
        by the state that served it (an LRU refit's state may part from an
        earlier one by K5's split-k order), relative to max|whole| (phase 7's
        gate): every bucket width and split plan K1 ran at is held to plain."""
        worst, scale = 0.0, 0.0
        for r, state, out in served:
            x = torch.as_tensor(r.x, dtype=torch.float32, device=dev)
            ref = state.w_rf.T @ rff.rff_plain(x, rf_tca.fused_transform_omega(state, P))
            if tuple(ref.shape) != out.shape or not bool(torch.isfinite(ref).all()):
                raise AssertionError(f"run {tag}: output {out.shape}, transform {ref.shape}")
            worst = max(worst, float((torch.as_tensor(out, device=dev) - ref).abs().max()))
            scale = max(scale, float(ref.abs().max()))
        err = worst / scale
        if not err <= SERVE_REQ_RTOL:
            raise AssertionError(f"run {tag}: served outputs differ from the plain transform by "
                                 f"{err} of max|whole| > {SERVE_REQ_RTOL}")
        return err

    def hist_delta(after, before):
        return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}

    # SV: open-loop Poisson load over four pairs and three slots
    zero()
    t0 = time.perf_counter()
    srv = AlignerServer(capacity=SV_CAPACITY, min_bucket=SV_BUCKETS[0], max_bucket=SV_BUCKETS[1],
                        device=dev)
    regen0 = rf_tca.fused_omega_cache_info()["regenerations"]
    for key, (xs, xt, _, fit_kw) in pairs.items():
        srv.fit_domain(key, xs, xt, **fit_kw)
    sync()
    fits_s = time.perf_counter() - t0
    rungs, b = [], SV_BUCKETS[0]
    while b <= SV_BUCKETS[1]:
        rungs.append(b)
        b *= 2
    planes = tuple(f"serve.transform.b{b}" for b in rungs)
    before = sentinel.counts()
    srv.warmup(keys[0])
    served = recorder(srv)
    sv = dict(fits_s=fits_s, pairs=len(pairs), capacity=SV_CAPACITY, buckets=rungs, levels={})
    by_level = []
    for li, rate in enumerate(SV_RATES):
        reqs = requests(SV_REQUESTS, SV_COLS)
        served.clear()
        st, disp = srv.store, srv.dispatcher
        h0, m0, d0, r0 = st.hits, st.misses, disp.dispatches, srv.refits
        rq0, bw0 = dict(disp.batch_requests), dict(disp.batch_columns)
        k1_0 = rff.LAUNCHES["rff"]
        t1 = time.perf_counter()
        res = run_open_loop(srv, reqs, rate=rate, seed=20 + li, service_scale=1.0)
        wall_s = time.perf_counter() - t1
        k1 = rff.LAUNCHES["rff"] - k1_0
        dispatches, refits = disp.dispatches - d0, srv.refits - r0
        if k1 != dispatches + refits:
            raise AssertionError(f"run SV {rate:g}: K1 launched {k1} times for {dispatches} "
                                 f"dispatches and {refits} refits (one each)")
        hits, misses = st.hits - h0, st.misses - m0
        per_dispatch = hist_delta(disp.batch_requests, rq0)
        level = dict(res.summary(), wall_s=wall_s, dispatches=dispatches, refits=refits,
                     hit_rate=hits / max(hits + misses, 1), k1_launches=k1,
                     requests_per_dispatch={str(k): v for k, v in sorted(per_dispatch.items())},
                     mean_requests_per_dispatch=sum(k * v for k, v in per_dispatch.items())
                     / max(dispatches, 1),
                     bucket_widths={str(k): v for k, v in sorted(
                         hist_delta(disp.batch_columns, bw0).items())})
        if level["completed"] != SV_REQUESTS:
            raise AssertionError(f"run SV {rate:g}: {level['completed']} of {SV_REQUESTS} done")
        sv["levels"][f"{rate:g}"] = level
        by_level.append(list(served))
        log(f"[run SV] {rate:g} req/s: p50 {level['p50_ms']:.3f} ms p99 {level['p99_ms']:.3f} ms, "
            f"throughput {level['throughput_rps']:.1f} req/s, {dispatches} dispatches "
            f"({level['mean_requests_per_dispatch']:.2f} requests each), buckets "
            f"{level['bucket_widths']}, hit rate {level['hit_rate']:.3f}, {refits} refits, "
            f"wall {wall_s:.2f} s")
    sv["launches"] = launches()
    sentinel.assert_stable(before, planes, expect=1)
    regens = rf_tca.fused_omega_cache_info()["regenerations"] - regen0
    for rate, done in zip(SV_RATES, by_level):  # after the counts (the Omega memo's hits)
        sv["levels"][f"{rate:g}"]["served_rel_err"] = check_served(f"SV {rate:g}", done)
    if regens != SV_PAIRS or sv["launches"]["prng"]["fused_omega"] != SV_PAIRS:
        raise AssertionError(f"run SV: Omega regenerated {regens} times, K4 launched "
                             f"{sv['launches']['prng']['fused_omega']}, for {SV_PAIRS} pairs")
    sv.update(omega_regenerations=regens, total_refits=srv.refits,
              planes_one_signature=list(planes), store=srv.store.snapshot())
    runs["SV"] = sv
    cross["SV_served_vs_plain_rel_err"] = max(
        lv["served_rel_err"] for lv in sv["levels"].values())
    log(f"[run SV] planes {list(planes)}: one signature each; Omega regenerated {regens} "
        f"times for {SV_PAIRS} pairs; served vs the plain transform "
        f"{cross['SV_served_vs_plain_rel_err']:.3g} of max|whole|; launches "
        f"{sv['launches']}")
    del srv, served, by_level

    # SM: a new target device admitted over the wire, float32 and qint8
    key = keys[0]
    xs, xt, held, fit_kw = pairs[key]
    x_new, probe = held[:, -40:-15], held[:, -15:]
    for codec in ("float32", "qint8"):
        zero()
        srv = AlignerServer(capacity=2, transport=WireTransport(resolve_codecs(codec), seed=SEED),
                            sentinel_prefix=f"serve.admit.{codec}", device=dev)
        srv.fit_domain(key, xs, xt, **fit_kw)
        v0, refits0 = srv.store.latest_version(key), srv.refits
        served_w = srv.store.get(key).state.w_rf
        t1 = time.perf_counter()
        res = srv.admit(key, x_new, role="target", sender=42)
        sync()
        admit_ms = (time.perf_counter() - t1) * 1e3
        counts = launches()
        if not res.delivered or srv.store.latest_version(key) != v0 or srv.refits != refits0:
            raise AssertionError(f"run SM {codec}: delivered {res.delivered}, version "
                                 f"{v0} -> {srv.store.latest_version(key)}, refits "
                                 f"{srv.refits - refits0}")
        scratch = rf_tca.rf_tca_fit(xs, xt, w_rf=f"fused:{srv.fused_seed}", device=dev, **fit_kw)
        got = rf_tca.rf_tca_transform(res.state, probe)
        want = rf_tca.rf_tca_transform(scratch, probe)
        div = float((got - want).abs().max())
        row = dict(codec=codec, admit_ms=admit_ms, bytes_up=res.bytes_up,
                   bytes_down=res.bytes_down, max_divergence_vs_refit=div,
                   store_version_changed=False, refit_ran=False, launches=counts)
        if codec == "float32":
            if not div <= ADMIT_ATOL:
                raise AssertionError(f"run SM {codec}: admitted vs refit {div} > {ADMIT_ATOL}")
        else:
            # the downlink rounds each entry of W_RF within one step of its bin,
            # so a transform moves by at most a step times sum_k |sigma_k(x)|
            step = float(served_w.abs().max()) / 127
            w_err = float((res.state.w_rf - served_w).abs().max())
            feats = rff_features(torch.as_tensor(probe, device=dev),
                                 rf_tca.fused_transform_omega(scratch, P))
            bound = step * feats.abs().sum(dim=0) + ADMIT_ATOL
            row.update(w_rf_step=step, w_rf_max_err=w_err,
                       max_divergence_over_bound=float(((got - want).abs() / bound).max()))
            if not (w_err <= step * (1 + 1e-6) and row["max_divergence_over_bound"] <= 1.0):
                raise AssertionError(f"run SM {codec}: W_RF {w_err} from served (step {step}), "
                                     f"transforms at {row['max_divergence_over_bound']} of the "
                                     f"codec's bound")
        runs[f"SM_{codec}"] = row
        log(f"[run SM] {codec}: admitted in {admit_ms:.2f} ms, {res.bytes_up} bytes up, "
            f"{res.bytes_down} down, transforms vs a refit {div:.3g}, no version change, no "
            f"refit; launches {row['launches']}")
        del srv, scratch

    # SD: a covariate shift mid-stream -> detection -> a moment-space refresh
    zero()
    key = keys[1]
    xs, xt, held, fit_kw = pairs[key]
    mon = obs.DriftMonitor(alpha=0.15, window=4, k_consecutive=2, calibration_windows=3,
                           threshold_scale=4.0, burnin_windows=SD_BURNIN)
    srv = AlignerServer(capacity=2, min_bucket=8, max_bucket=64, sentinel_prefix="serve.drift",
                        device=dev)
    srv.fit_domain(key, xs, xt, **fit_kw)
    srv.attach(drift=mon)
    srv.warmup(key)
    srv.rearm_drift()
    stale = srv.store.get(key).state
    offset = SD_SHIFT_STD * held.std(axis=1, keepdims=True)
    reqs = requests(SD_CALM, SD_COLS, pool=key) + requests(SD_SHIFTED, SD_COLS, pool=key,
                                                           offset=offset)
    injection_t = float(poisson_arrivals(SD_RATE, SD_CALM + SD_SHIFTED, seed=52)[SD_CALM])
    v0 = srv.store.latest_version(key)
    res = run_open_loop(srv, reqs, rate=SD_RATE, seed=52)
    counts = launches()
    fired = [r for r in mon.history if r.fired]
    fire_evals = [i for i, r in enumerate(mon.history) if r.fired]
    refire_evals = fire_evals[-1] - fire_evals[0] if fire_evals else None
    bumps = srv.store.latest_version(key) - v0
    # bench_serve.py's contract: detection after the shift (no calm false
    # fire), and every fire one moment-space refresh and one version bump.
    # The first refresh re-pins the reference to the recent window's pooled
    # moment, which still holds batches from before the shift, so one second
    # fire may follow it (the monitor's own logic, tests/test_torch_obs.py
    # holds it against the reference's); the second refresh pools only
    # shifted batches, and no third fire is allowed
    if not (fired and fired[0].t >= injection_t and len(fired) <= SD_MAX_FIRES
            and refire_evals <= SD_REFIRE_EVALS
            and bumps == len(fired) == mon.fires == srv.moment_refreshes):
        raise AssertionError(f"run SD: fires at {[r.t for r in fired]} (shift at "
                             f"{injection_t}; at most {SD_MAX_FIRES}, within "
                             f"{SD_REFIRE_EVALS} evaluations: {refire_evals}), {bumps} "
                             f"version bumps, {srv.moment_refreshes} moment refreshes")
    probe_drift = torch.as_tensor(np.ascontiguousarray(held[:, -40:] + offset), device=dev)

    def disc(state):
        zs = rf_tca.rf_tca_transform(state, xs).mean(dim=1)
        zt = rf_tca.rf_tca_transform(state, probe_drift).mean(dim=1)
        return float(((zs - zt) ** 2).sum())

    sd = dict(res.summary(), injection_t=injection_t, detection_t=fired[0].t,
              detection_latency_s=fired[0].t - injection_t, fires=mon.fires,
              fire_times=[r.t for r in fired], refire_evaluations=refire_evals,
              evaluations_after_first_fire=len(mon.history) - 1 - fire_evals[0],
              mmd_over_threshold_after_last_fire=max(
                  (r.mmd / r.threshold for r in mon.history[fire_evals[-1] + 1:]),
                  default=None),
              threshold=mon.pair_threshold(key), version_bumps=bumps,
              moment_refreshes=srv.moment_refreshes, disc_stale=disc(stale),
              disc_refreshed=disc(srv.store.get(key).state), launches=counts)
    if not sd["disc_refreshed"] < sd["disc_stale"]:
        raise AssertionError(f"run SD: the refreshed aligner leaves the drifted target at "
                             f"{sd['disc_refreshed']}, the stale one at {sd['disc_stale']}")
    runs["SD"] = sd
    log(f"[run SD] shift at {injection_t:.4f} s, detected at {sd['detection_t']:.4f} s "
        f"(latency {sd['detection_latency_s'] * 1e3:.2f} ms virtual), fires at "
        f"{sd['fire_times']} ({refire_evals} evaluations apart; after the last, RF-MMD at most "
        f"{sd['mmd_over_threshold_after_last_fire']} of the threshold), {bumps} version bumps; "
        f"discrepancy of the drifted target {sd['disc_stale']:.4g} stale -> "
        f"{sd['disc_refreshed']:.4g} refreshed; launches {sd['launches']}")
    del srv, stale

    # SO: telemetry off and on behind one fitted state: bit for bit, and the
    # wall-clock overhead of the request tracer, an SLO engine and the drift
    # monitor (its probed planes)
    zero()
    key = keys[2]
    xs, xt, held, fit_kw = pairs[key]
    off = AlignerServer(capacity=2, min_bucket=64, max_bucket=256, sentinel_prefix="serve.off",
                        device=dev)
    on = AlignerServer(capacity=2, min_bucket=64, max_bucket=256, sentinel_prefix="serve.on",
                       device=dev)
    off.fit_domain(key, xs, xt, **fit_kw)
    on.fit_domain(key, xs, xt, **fit_kw)
    # one state behind both: two fits may part by a rounding (K5's split-k order)
    on.store.put(key, off.store.get(key))
    on.attach(request_tracer=obs.RequestTracer(rate=SO_SAMPLE),
              slo=obs.SloEngine([obs.Slo("serve.latency", target=0.9, bound=10.0,
                                         window_fast_s=0.05, window_slow_s=0.5)]),
              drift=obs.DriftMonitor(alpha=0.15, window=4, k_consecutive=2, threshold=0.5))
    off.warmup(key)
    on.warmup(key)
    on.rearm_drift()
    deg = requests(SO_DEGENERACY, SO_COLS, pool=key)
    outs_off = [o for _, o in off.serve(deg)]
    with obs.use_registry(obs.MetricsRegistry()), obs.use_tracer(obs.Tracer()):
        outs_on = [o for _, o in on.serve(deg)]
    if not all(np.array_equal(a, b) for a, b in zip(outs_off, outs_on)):
        raise AssertionError("run SO: telemetry on changed a served output")
    reqs = requests(SO_REQUESTS, SO_COLS, pool=key)
    ratios = []
    for _ in range(SO_PAIRS):
        t1 = time.perf_counter()
        run_open_loop(off, reqs, rate=SO_RATE, seed=32)
        t_off = time.perf_counter() - t1
        with obs.use_registry(obs.MetricsRegistry()), obs.use_tracer(obs.Tracer()):
            t1 = time.perf_counter()
            run_open_loop(on, reqs, rate=SO_RATE, seed=32)
            t_on = time.perf_counter() - t1
        ratios.append(t_on / t_off)
    so = dict(bitwise_equal=True, overhead_ratio_median=float(np.median(ratios)),
              overhead_ratio_min=min(ratios), overhead_ratios=ratios,
              drift_fires=on.drift.fires, traced_requests=on.reqtrace.emitted,
              launches=launches())
    runs["SO"] = so
    log(f"[run SO] {SO_DEGENERACY} requests bit for bit with telemetry on; wall-clock "
        f"on/off {so['overhead_ratio_median']:.3f} (median of {SO_PAIRS}, min "
        f"{so['overhead_ratio_min']:.3f}); {so['traced_requests']} request trees")
    del off, on

    # HP: phase 10's H batched for HP_ROUNDS rounds with and without probes
    zero()
    kw = dict(fed["fed_kw"], n_rounds=HP_ROUNDS, engine="batched", scenario=fed["full"])
    trainer, proto = fed["FedRFTCATrainer"], fed["ProtocolConfig"]
    sources, target = fed["doms5"][:4], fed["doms5"][4]
    tr_off = trainer(sources, target, fed["fed_cfg"], proto(**kw), device=dev)
    tr_off.train()
    tr_on = trainer(sources, target, fed["fed_cfg"], proto(**kw, probe=True), device=dev)
    before = sentinel.counts()
    tr_on.train()
    sync()
    sentinel.assert_stable(before, ("engine.round",), expect=1)
    same = all(torch.equal(a, b) for a, b in zip(fed["params_of"](tr_off),
                                                 fed["params_of"](tr_on)))
    probes = tr_on.last_probes
    need = ("moment_mass", "update_norm", "tgt_update_norm")
    if not same or not all(k in probes and np.isfinite(probes[k]).all() for k in need):
        raise AssertionError(f"run HP: parameters bit for bit {same}, probes "
                             f"{ {k: probes.get(k) for k in need} }")
    runs["HP"] = dict(rounds=HP_ROUNDS, bit_identical=True,
                      probes={k: np.asarray(v).tolist() for k, v in probes.items()},
                      launches=launches())
    log(f"[run HP] {HP_ROUNDS} probed rounds bit for bit the unprobed; engine.round one "
        f"signature; last probes {runs['HP']['probes']}")
    runs["HP"]["phase_14_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 14 (SV, SM, SD, SO, HP) {runs['HP']['phase_14_s']:.1f} s")
    return runs, cross


def k11b_bytes(shape) -> int:
    """Bytes K11b moves at a bf16 (b, h, kv, s, d, dv): q, do, dq; k, v, dk,
    dv; the fp32 o_acc and lse."""
    b, h, kv, s, d, dv = shape
    return (2 * b * h * s * (d + dv) + 2 * b * kv * s * (d + dv)) * 2 + (
        b * h * s * dv + b * h * s) * 4


def k11b_copies(torch, fa, shape) -> list:
    """K11b's bf16 causal inputs (q, k, v, o_acc, lse, do) at ``shape`` from
    seeds 0, 1, ...: enough copies to cycle past the L2."""
    b, h, kv, s, d, dv = shape
    dev = torch.device("cuda")
    copies = []
    for i in range(max(2, -(-L2_FLUSH_BYTES // k11b_bytes(shape)))):
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16) for sh in
                       ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv), (b, h, s, dv)))
        _, lse, o_acc = fa.flash_attention(q, k, v, return_lse=True)
        copies.append((q, k, v, o_acc, lse, do))
    return copies


def k11b_times(torch, fa, copies) -> dict:
    """K11b, its plain version and ``scaled_dot_product_attention``'s backward
    (``torch.autograd.grad`` through it, causal, GQA) on ``copies`` in turn:
    K11b's ``timed`` fields, ``plain_ms`` and ``library_ms``."""
    turn = itertools.cycle(copies)
    kt = timed(torch, lambda: fa.flash_attention_backward(*next(turn)), 10)
    pt = timed(torch, lambda: fa.flash_attention_backward_plain(*next(turn)), 2)
    sdpa = []
    for q, k, v, _, _, do in copies:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                             enable_gqa=True)
        sdpa.append((o, leaves, do))
    sturn = itertools.cycle(sdpa)

    def sdpa_bwd():
        o, leaves, do = next(sturn)
        torch.autograd.grad(o, leaves, do, retain_graph=True)

    lt = timed(torch, sdpa_bwd, 10)
    return dict(kt, plain_ms=pt["ms"], library_ms=lt["ms"])


def k11b_rows(torch, dev, shapes, timed_shapes) -> dict:
    """Phase 15a, K11b: its ptxas lines and HGMMA count, then the backward
    kernels against the plain version and the forward's lse against plain's,
    at ``shapes`` (b, h, kv, s, d, dv, dtype, causal, window, v_scale); two
    launches on the same inputs bit for bit and times at ``timed_shapes``
    (bf16 causal) beside the plain backward and
    ``scaled_dot_product_attention``'s backward.  Returns the kernels line's
    K11b entry and the forward's re-timing."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    lines = ptxas_entries(_build.ptxas("flash_attention_bwd"), ("_tc_kernel",))
    for line in lines:
        log(f"[K11b] ptxas {line}")
    if not lines or any("0 bytes spill stores" not in line for line in lines):
        log("[K11b] a tensor-core kernel spills (or ptxas reported none)")
    hgmma = sum("HGMMA" in line for line in _build.sass("flash_attention_bwd").splitlines())
    log(f"[K11b] {hgmma} HGMMA instructions in the SASS of the flash_attention_bwd library")
    if hgmma == 0:
        raise AssertionError("K11b: no HGMMA in the SASS: the bf16 path is not on wgmma")

    def bf16_ulp(x):
        return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126))) - 7)

    def inputs(b, h, kv, s, d, dv, dtype, seed, v_scale=1.0):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev) for shape in
                       ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv), (b, h, s, dv)))
        return q.to(dtype), k.to(dtype), (v * v_scale).to(dtype), do.to(dtype)

    worst = {"float32": 0.0, "bfloat16": 0.0, "lse": 0.0, "gate_units": 0.0}
    for b, h, kv, s, d, dv, dt, causal, window, v_scale in shapes:
        what = (f"({b}, {h}, {kv}, {s}, {d}, {dv}) {dt} causal={causal} window={window} "
                f"v x {v_scale}")
        q, k, v, do = inputs(b, h, kv, s, d, dv, getattr(torch, dt), b * h * s + d + window,
                             v_scale)
        _, lse, o_acc = fa.flash_attention(q, k, v, causal=causal, window=window,
                                           return_lse=True)
        _, lse_p, _ = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                               return_lse=True)
        lse_err = float((lse - lse_p).abs().max())
        if not lse_err <= K11B_LSE_ATOL:
            raise AssertionError(f"K11 lse {what}: {lse_err} > {K11B_LSE_ATOL}")
        worst["lse"] = max(worst["lse"], lse_err)
        got = fa.flash_attention_backward(q, k, v, o_acc, lse, do, causal=causal, window=window)
        # plain: autograd through the plain forward on the inputs' fp32
        # values, rounded once to their dtype (autograd through the bf16
        # plain rounds each query head's dK, dV to bf16 before the GQA sum)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(fa.flash_attention_plain(*leaves, causal=causal,
                                                             window=window),
                                    leaves, do.float())
        del leaves
        for name, a, p in zip(("dq", "dk", "dv"), got, plain):
            p = p.to(a.dtype).float()
            err = (a.float() - p).abs()
            cap = K11B_RTOL * max(1.0, float(p.abs().max()))
            gate = bf16_ulp(p) + cap if a.dtype == torch.bfloat16 else torch.full_like(p, cap)
            units = float((err / gate).max())
            if not units <= 1.0:
                raise AssertionError(f"K11b {what} {name}: {units:.3g} gate units from plain")
            worst[dt] = max(worst[dt], float(err.max()))
            worst["gate_units"] = max(worst["gate_units"], units)
        del q, k, v, do, got, plain, lse, o_acc
    log(f"[K11b] {len(shapes)} shapes (v x {K11_V_SCALE} at {K11_LARGE_V}): lse within "
        f"{K11B_LSE_ATOL} of plain (max "
        f"{worst['lse']:.3g}); dq, dk, dv within {K11B_RTOL} x max(1, max|plain|) at fp32 "
        f"(max abs err {worst['float32']:.3g}) and one bf16 ULP of plain plus that at bf16 "
        f"(max abs err {worst['bfloat16']:.3g}); worst {worst['gate_units']:.3f} gate units")

    def causal_pairs(s):
        return s * (s + 1) // 2

    timed_rows, fwd = {}, {}
    for b, h, kv, s, d, dv in timed_shapes:
        copies = k11b_copies(torch, fa, (b, h, kv, s, d, dv))
        flops = 2 * (3 * d + 2 * dv) * b * h * causal_pairs(s)
        nbytes = k11b_bytes((b, h, kv, s, d, dv))
        b_ms, b_by = bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS)
        ffma_ms, _ = bound_ms(flops, nbytes)
        first = fa.flash_attention_backward(*copies[0])
        again = fa.flash_attention_backward(*copies[0])
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"K11b {(b, h, kv, s, d, dv)}: two launches on the same "
                                 f"inputs differ")
        del first, again
        kt = k11b_times(torch, fa, copies)
        turn = itertools.cycle(copies)
        f_plain = timed(torch, lambda: fa.flash_attention(*next(turn)[:3]), 20)
        f_lse = timed(torch, lambda: fa.flash_attention(*next(turn)[:3], return_lse=True), 20)
        del copies, turn
        key = (b, h, kv, s, d, dv)
        timed_rows[key] = dict(ms=kt["ms"], host_ms=kt["host_ms"], queued=kt["queued"],
                               plain_ms=kt["plain_ms"], library_ms=kt["library_ms"],
                               bound_ms=b_ms, bound_by=b_by, bound_ffma_ms=ffma_ms,
                               tflops=flops / kt["ms"] / 1e9, bf16_plan=fa.bwd_bf16_plan(d, dv))
        fwd[key] = dict(ms=f_plain["ms"], lse_ms=f_lse["ms"])
        log(f"[K11b] {key} bf16 causal: two launches bit for bit; kernel {kt['ms']:.4f} ms "
            f"(host {kt['host_ms']:.4f} ms "
            f"a call, queued {kt['queued']}, {flops / kt['ms'] / 1e9:.2f} TFLOP/s), plain "
            f"{kt['plain_ms']:.4f} ms, scaled_dot_product_attention's backward "
            f"{kt['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, bf16 tensor cores; {ffma_ms:.4f} ms at the FFMA "
            f"rate); K11 forward {f_plain['ms']:.4f} ms, with lse and the fp32 output "
            f"{f_lse['ms']:.4f} ms; plan {timed_rows[key]['bf16_plan']}")
    first = timed_shapes[0]
    row = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="none: backward of src/repro/kernels/flash_attention.py:69 (the reference "
                 "differentiates its jnp scan, src/repro/models/attention.py:81)",
        design="bf16: wgmma fed by TMA (dK/dV and dQ kernels, P and dS in bf16 parts); "
               "fp32: FFMA", p_ds_parts=timed_rows[first]["bf16_plan"]["p_ds_parts"],
        hgmma=hgmma, deterministic=True,
        max_abs_err=max(worst["float32"], worst["bfloat16"]), max_abs_err_by=worst,
        tolerance=f"dq, dk, dv: fp32 {K11B_RTOL} x max(1, max|plain|); bf16 one bf16 ULP of "
                  f"plain plus that; plain = autograd of flash_attention_plain on the fp32 "
                  f"inputs, rounded once; lse atol {K11B_LSE_ATOL}",
        shape=f"{first} bf16 causal", bound_peak="989 TFLOP/s bf16; 3.35 TB/s",
        library="torch.autograd.grad through scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        **timed_rows[first],
        hd128=dict(shape=f"{timed_shapes[1]} bf16 causal", **timed_rows[timed_shapes[1]]))
    return row, fwd


def train_phase(torch, dev, doms0, counters) -> tuple[dict, dict]:
    """Phase 15 after K11b: T (smollm-135m training through
    ``launch.train.build_train_step``), TC (one step, card against CPU) and
    BL (the baselines on the card and the CPU; RF-TCA at phase 7's width);
    returns (runs, K11 launches by run)."""
    import numpy as np

    from repro_torch import baselines
    from repro_torch.configs import get_config
    from repro_torch.data import Domain, TokenStream, make_domains
    from repro_torch.federated import ClientConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.utils.tree import tree_flatten_with_paths, tree_map

    runs = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # T: full width and depth, bf16, remat on, the FDA head on two clients
    cfg = get_config(LM_ARCH)
    if not (cfg.remat and cfg.dtype == torch.bfloat16 and cfg.fda_lambda):
        raise AssertionError(f"T: {LM_ARCH} config lost remat, bf16 or the FDA head")
    model = LM(cfg)
    opt = adamw(cosine_schedule(T_LR, warmup=T_WARMUP, total=T_STEPS), weight_decay=0.01)
    step_fn = build_train_step(model, opt, T_CLIENTS)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(SEED, device=dev)
    state = opt.init(params)
    stream = TokenStream(cfg.vocab_size, T_BATCH, T_SEQ, seed=1)
    losses, ces, mmds, gnorms, step_ms, draw_ms = [], [], [], [], [], []
    fa.LAUNCHES["flash_attention"] = fa.LAUNCHES["flash_attention_bwd"] = 0
    for _ in range(T_STEPS):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        sync()
        t1 = time.perf_counter()
        params, state, met = step_fn(params, state, batch)
        sync()
        t2 = time.perf_counter()
        draw_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        losses.append(float(met["loss"]))
        ces.append(float(met["ce"]))
        mmds.append(float(met["mmd"]))
        gnorms.append(float(met["grad_norm"]))
    t_launch = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    if not all(np.isfinite(x).all() for x in (losses, ces, mmds)):
        raise AssertionError(f"T: non-finite loss, ce or mmd: {losses} {ces} {mmds}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first + 0.5:  # tests/test_launch.py:55-62
        raise AssertionError(f"T: last-10 mean loss {last} not below the first-10 {first} + 0.5")
    fwd_per, bwd_per = 2 * cfg.n_layers, cfg.n_layers  # remat runs each forward twice
    if t_launch != {"flash_attention": fwd_per * T_STEPS,
                    "flash_attention_bwd": bwd_per * T_STEPS}:
        raise AssertionError(f"T: K11 / K11b launched {t_launch}, expected {fwd_per} / "
                             f"{bwd_per} a step over {T_STEPS} steps")
    # the FDA head on the trained state: Omega gets no gradient, W_RF does
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch, T_CLIENTS)
    paths, leaves = tree_flatten_with_paths(live)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves, allow_unused=True)))
    g_omega, g_w = grads["fda/omega"], grads["fda/w_rf"]
    if not (g_omega is None or float(g_omega.abs().max()) == 0.0) or not float(
            g_w.abs().max()) > 0:
        raise AssertionError("T: Omega has a gradient or W_RF has none")
    del live, loss, leaves, grads, params, state, batch
    warm = step_ms[1:]
    runs["T"] = dict(
        arch=LM_ARCH, dtype="bfloat16", n_layers=cfg.n_layers, remat=True, batch=T_BATCH,
        seq=T_SEQ, clients=T_CLIENTS, steps=T_STEPS, fda=dict(n_rff=cfg.fda_n_rff, m=cfg.fda_m,
                                                              lam=cfg.fda_lambda),
        losses=losses, ce=ces, mmd=mmds, grad_norm=gnorms, first10=first, last10=last,
        step_ms_first=step_ms[0], step_ms_p50=float(np.percentile(warm, 50)),
        step_ms_p99=float(np.percentile(warm, 99)),
        draw_ms_p50=float(np.percentile(draw_ms, 50)),
        tokens_per_s=T_BATCH * T_SEQ / (float(np.percentile(warm, 50)) / 1e3),
        peak_bytes=int(peak), k11_launches=t_launch["flash_attention"],
        k11b_launches=t_launch["flash_attention_bwd"], omega_grad_zero=True)
    r = runs["T"]
    log(f"[run T] {LM_ARCH} bf16 remat, {cfg.n_layers} layers, batch {T_BATCH} x {T_SEQ}, "
        f"{T_CLIENTS} clients, {T_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first-10 {first:.4f}, last-10 {last:.4f}), gradient norm before clipping "
        f"{min(gnorms):.3g} to {max(gnorms):.3g}; step first {step_ms[0]:.1f} ms, p50 "
        f"{r['step_ms_p50']:.2f} ms p99 {r['step_ms_p99']:.2f} ms, batch draw p50 "
        f"{r['draw_ms_p50']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB above the start; K11 {t_launch['flash_attention']} launches "
        f"({fwd_per} a step), K11b {t_launch['flash_attention_bwd']} ({bwd_per} a step); "
        f"Omega's gradient 0, W_RF's not")

    # TC: smollm-135m's width at two layers, fp32, one step card vs CPU from
    # one LM.init state.  The random-init stack is ill-conditioned in fp32
    # (tests/test_torch_train.py): the gate adds four times what a 1e-7
    # relative nudge of the weights moves the CPU's own gradient
    tc_cfg = get_config(LM_ARCH).reduced(
        n_layers=TC_LAYERS, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size, fda_n_rff=cfg.fda_n_rff,
        fda_m=cfg.fda_m, dtype=torch.float32)
    tc = LM(tc_cfg)
    p_cpu = tc.init(SEED, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in next(TokenStream(tc_cfg.vocab_size, TC_BATCH,
                                                                 TC_SEQ, seed=1)).items()}

    def value_and_grads(p, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, met = tc.loss(live, batch, T_CLIENTS)
        paths, leaves = tree_flatten_with_paths(live)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        return ({k: float(v.detach()) for k, v in {"loss": loss, **met}.items()},
                {k: None if x is None else x.detach().cpu() for k, x in zip(paths, g)})

    fa.LAUNCHES["flash_attention"] = fa.LAUNCHES["flash_attention_bwd"] = 0
    m_card, g_card = value_and_grads(tree_map(lambda t: t.to(dev), p_cpu),
                                     {k: v.to(dev) for k, v in tb.items()})
    sync()
    tc_launch = dict(fa.LAUNCHES)
    m_cpu, g_cpu = value_and_grads(p_cpu, tb)
    gen = torch.Generator().manual_seed(1)
    _, g_nudge = value_and_grads(
        tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)), p_cpu), tb)

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    tc_run = dict(layers=TC_LAYERS, batch=TC_BATCH, seq=TC_SEQ, k11_launches=tc_launch)
    worst_units, worst_rel, worst_nudge = 0.0, 0.0, 0.0
    for key in ("loss", "ce", "mmd"):
        d = abs(m_card[key] - m_cpu[key]) / max(1.0, abs(m_cpu[key]))
        tc_run[f"{key}_rel"] = d
        if not d <= TC_RTOL:
            raise AssertionError(f"TC: {key} card {m_card[key]} CPU {m_cpu[key]}")
    for k, g in g_cpu.items():
        if g is None:
            if g_card[k] is not None:
                raise AssertionError(f"TC: {k} has a gradient on the card only")
            continue
        e, moved = rel(g_card[k], g), rel(g_nudge[k], g)
        worst_rel, worst_nudge = max(worst_rel, e), max(worst_nudge, moved)
        worst_units = max(worst_units, e / (TC_RTOL + 4 * moved))
        if not e <= TC_RTOL + 4 * moved:
            raise AssertionError(f"TC: gradient {k} card vs CPU {e:.3g} of max(1, max|leaf|), "
                                 f"past {TC_RTOL} + 4 x the CPU's own 1e-7-nudge movement "
                                 f"{moved:.3g}")
    if tc_launch != {"flash_attention": TC_LAYERS, "flash_attention_bwd": TC_LAYERS}:
        raise AssertionError(f"TC: K11 / K11b launched {tc_launch}")
    tc_run.update(grad_rel_max=worst_rel, nudge_rel_max=worst_nudge, gate_units=worst_units)
    runs["TC"] = tc_run
    log(f"[run TC] {LM_ARCH} width, {TC_LAYERS} layers, fp32, batch {TC_BATCH} x {TC_SEQ}, "
        f"card vs CPU from one state: loss, ce, mmd within "
        f"{max(tc_run[k + '_rel'] for k in ('loss', 'ce', 'mmd')):.3g}; gradient leaves at most "
        f"{worst_rel:.3g} of max(1, max|leaf|) (the CPU's own 1e-7-nudge movement up to "
        f"{worst_nudge:.3g}; {worst_units:.3f} of the gate)")

    # BL: tests/test_baselines.py's suite on the card and on the CPU
    doms = make_domains(3, 250, shift=1.0, seed=5)
    s, t = doms[:2], doms[2]
    fed_cfg = ClientConfig(input_dim=s[0].x.shape[0], n_classes=5)
    suite = (
        ("source_only", lambda d: baselines.source_only(s, t, seed=0, device=d), "close"),
        ("tca", lambda d: baselines.tca_baseline(s, t, gamma=1e-3, m=16, device=d), "equal"),
        ("r_tca", lambda d: baselines.tca_baseline(s, t, gamma=1e-3, m=16, variant="r",
                                                   device=d), "equal"),
        ("rf_tca", lambda d: baselines.rf_tca_baseline(s, t, gamma=1e-3, n_features=1024,
                                                       m=16, device=d), "close"),
        ("coral", lambda d: baselines.coral_baseline(s, t, device=d), "equal"),
        ("jda", lambda d: baselines.jda_baseline(s, t, gamma=1e-3, iters=2, device=d), "equal"),
        ("dann", lambda d: baselines.dann_mmd_baseline(s, t, steps=150, device=d), "close"),
        ("fedavg", lambda d: baselines.fedavg_baseline(s, t, fed_cfg, device=d), "close"),
    )
    bl = {}
    for name, fn, rule in suite:
        t0 = time.perf_counter()
        acc = fn(dev)
        sync()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc_cpu = fn("cpu")
        cpu_s = time.perf_counter() - t0
        bl[name] = dict(acc=acc, acc_cpu=acc_cpu, card_s=card_s, cpu_s=cpu_s, rule=rule)
        if not 0.0 <= acc <= 1.0:
            raise AssertionError(f"BL {name}: accuracy {acc}")
        if rule == "equal" and acc != acc_cpu:
            raise AssertionError(f"BL {name}: card {acc} != CPU {acc_cpu}")
        if rule == "close" and not abs(acc - acc_cpu) <= BL_MLP_ATOL:
            raise AssertionError(f"BL {name}: card {acc} vs CPU {acc_cpu}, past {BL_MLP_ATOL}")
    if not bl["tca"]["acc"] > 1.0 / 5 + 0.05:  # tests/test_baselines.py
        raise AssertionError(f"BL: TCA {bl['tca']['acc']} does not beat 5-class chance + 0.05")
    # RF-TCA at phase 7's Office-31 width on its domains (K1, K2 counted)
    for c in counters.values():
        for k in c:
            c[k] = 0
    src = Domain("A", doms0[0].x, doms0[0].y)
    tgt = Domain("W", doms0[1].x[:, :N_T], doms0[1].y[:N_T])
    t0 = time.perf_counter()
    acc = baselines.rf_tca_baseline([src], tgt, n_features=BL_WIDE_N, m=BL_WIDE_M, gamma=GAMMA,
                                    device=dev)
    sync()
    wide_s = time.perf_counter() - t0
    k1 = counters["rff"]["rff"]
    k2 = sum(counters["operand_gram"].values())
    if not (0.0 <= acc <= 1.0 and k1 > 0 and k2 > 0):
        raise AssertionError(f"BL wide RF-TCA: accuracy {acc}, K1 {k1}, K2 {k2} launches")
    bl["rf_tca_office31"] = dict(acc=acc, card_s=wide_s, n_features=BL_WIDE_N, m=BL_WIDE_M,
                                 p=P, n_s=N_S, n_t=N_T, k1_launches=k1, k2_launches=k2)
    runs["BL"] = bl
    log("[run BL] make_domains(3, 250, shift=1.0, seed=5), card vs CPU: " + ", ".join(
        f"{n} {r['acc']:.4f} / {r['acc_cpu']:.4f} ({r['card_s']:.2f} s / {r['cpu_s']:.2f} s)"
        for n, r in bl.items() if "acc_cpu" in r) + f"; RF-TCA at p={P}, n_S={N_S}, "
        f"n_T={N_T}, N={BL_WIDE_N}, m={BL_WIDE_M}: {acc:.4f} in {wide_s:.2f} s (K1 {k1}, K2 "
        f"{k2} launches)")
    return runs, {"T": t_launch, "TC": tc_launch}


def moe_phase(torch, dev, k11_check_model) -> tuple[dict, dict]:
    """Phase 16, the MoE family: Q and DS through ``serve.generate`` (K11's
    first launch of each under ``k11_check_model``, phase 12's rule), QC / DC
    and QH / DH block by block, DP the sharded round; returns (runs, K11
    launches by run)."""
    import socket
    from dataclasses import replace

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import fedrf_paper, get_config
    from repro_torch.federated import distributed as fdist
    from repro_torch.federated import init_params, make_omega
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import LM, moe
    from repro_torch.models import blocks as B
    from repro_torch.models.param import materialize
    from repro_torch.optim import adam
    from repro_torch.utils.tree import tree_leaves, tree_map

    runs, k11_runs = {}, {}
    cpu = torch.device("cpu")
    seen = []
    k11_launch = fa.flash_attention

    def recording_flash_attention(q, k, v, *, causal=True, window=0):
        out = k11_launch(q, k, v, causal=causal, window=window)
        if q.is_cuda and not seen:
            seen.append((tuple(t.clone() for t in (q, k, v, out)), causal, window))
        return out

    def rel_err(a, b):  # |a - b| over max(1, max|b|), b the CPU's
        b = b.float()
        return float((a.float().cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))

    # ---- Q and DS: serve.generate at full width, bf16 ------------------------
    def serve_run(tag, cfg):
        model = LM(cfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = model.init(SEED, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab_size, (M_BATCH, M_PROMPT),
                                generator=torch.Generator().manual_seed(SEED)).to(dev)
        gens = {}
        fa.flash_attention = recording_flash_attention
        try:
            for run in ("first", "warm"):
                fa.LAUNCHES["flash_attention"] = 0
                res = serve.generate(model, params, prompts, M_GEN)
                torch.cuda.synchronize()
                launches = fa.LAUNCHES["flash_attention"]
                if launches != cfg.n_layers:
                    raise AssertionError(f"run {tag} ({run}): K11 launched {launches} times, "
                                         f"not once per layer ({cfg.n_layers})")
                toks = res["tokens"]
                if tuple(toks.shape) != (M_BATCH, M_GEN) or not bool(
                        ((toks >= 0) & (toks < cfg.vocab_size)).all()):
                    raise AssertionError(f"run {tag} ({run}): tokens {tuple(toks.shape)} "
                                         f"outside the vocab")
                if not all(bool(torch.isfinite(lg).all()) for lg in res["logits"]):
                    raise AssertionError(f"run {tag} ({run}): non-finite logits")
                decode_s = sum(res["step_ms"]) / 1e3
                gens[run] = dict(
                    prefill_s=res["prefill_s"],
                    prefill_tokens_per_s=M_BATCH * M_PROMPT / res["prefill_s"],
                    decode_step_ms_p50=float(np.percentile(res["step_ms"], 50)),
                    decode_step_ms_p99=float(np.percentile(res["step_ms"], 99)),
                    decode_tokens_per_s=M_BATCH * (M_GEN - 1) / decode_s,
                    k11_launches=launches, sample=toks[0, :8].tolist())
                k11_runs[f"{tag}_{run}"] = launches
        finally:
            fa.flash_attention = k11_launch
        peak = torch.cuda.max_memory_allocated() - base
        (q, k, v, out), causal, window = seen.pop()
        gate = k11_check_model(q, k, v, out, causal, window,
                               f"run {tag} first launch {tuple(q.shape)}")
        del q, k, v, out
        # the card's own time of a warm prefill and a decode step, queued
        # behind a device-side sleep (the host's enqueue time apart)
        pf = timed(torch, lambda: model.prefill(params, {"tokens": prompts}), 2)
        _, cache = model.prefill(params, {"tokens": prompts})
        cache = serve.grow_cache(cache, M_GEN)
        tok = prompts[:, -1:]
        dc = timed(torch, lambda: model.decode_step(params, cache, {"tokens": tok}, M_PROMPT), 5)
        del params, cache, res, prompts
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        w = gens["warm"]
        out = dict(arch=cfg.arch_id, dtype="bfloat16", n_layers=cfg.n_layers,
                   n_experts=cfg.n_experts, top_k=cfg.top_k, batch=M_BATCH, prompt_len=M_PROMPT,
                   gen=M_GEN, param_count=model.param_count(), param_bytes=param_bytes,
                   init_s=init_s, peak_bytes=int(peak),
                   capacity_prefill=moe.capacity(cfg, M_BATCH * M_PROMPT),
                   capacity_decode=moe.capacity(cfg, M_BATCH),
                   k11_first_launch_max_abs_err=gate["max_abs_err"], k11_first_launch_gate=gate,
                   prefill_device_ms=pf["ms"], prefill_host_ms=pf["host_ms"],
                   prefill_queued=pf["queued"], decode_step_device_ms=dc["ms"],
                   decode_step_host_ms=dc["host_ms"], decode_step_queued=dc["queued"],
                   **{f"{k}_{run}": v for run, r in gens.items() for k, v in r.items()})
        log(f"[run {tag}] {cfg.arch_id} bf16, {cfg.n_layers} layers, {model.param_count()} "
            f"parameters ({param_bytes / 2**30:.2f} GiB), init {init_s:.2f} s; {M_BATCH} x "
            f"{M_PROMPT} prompt, {M_GEN} tokens: prefill {gens['first']['prefill_s']:.4f} s "
            f"first, {w['prefill_s']:.4f} s warm ({w['prefill_tokens_per_s']:.1f} tokens/s); "
            f"decode step p50 {w['decode_step_ms_p50']:.3f} ms p99 "
            f"{w['decode_step_ms_p99']:.3f} ms ({w['decode_tokens_per_s']:.1f} tokens/s); K11 "
            f"{cfg.n_layers} launches a prefill, the first within the gate "
            f"({gate['max_abs_err']:.3g} from plain; gate units "
            f"{ {k: round(x, 3) for k, x in gate.items() if k.endswith('units')} }); capacity "
            f"{out['capacity_prefill']} / {out['capacity_decode']}; on the card a prefill takes "
            f"{pf['ms']:.3f} ms (host {pf['host_ms']:.3f}, queued {pf['queued']}) and a decode "
            f"step {dc['ms']:.3f} ms (host {dc['host_ms']:.3f}, queued {dc['queued']}); peak "
            f"{peak / 2**30:.2f} GiB above the start")
        return out

    runs["Q"] = serve_run("Q", replace(get_config(Q_ARCH), n_layers=Q_LAYERS))
    runs["DS"] = serve_run("DS", get_config(DS_ARCH))

    # ---- QC / DC, QH / DH: one block at fp32 from one state -------------------
    routes = []
    route, dispatch = moe.route, moe.dispatch

    def recording_route(params, xt, cfg):
        out = route(params, xt, cfg)
        routes.append({"probs": out[0], "top_e": out[2]})
        return out

    def recording_dispatch(top_e, e, c):
        slot, keep = dispatch(top_e, e, c)
        routes[-1]["keep"] = keep
        return slot, keep

    def routed(fn, *args, **kw):
        """``fn(*args, **kw)`` and the routing of its one MoE call."""
        routes.clear()
        moe.route, moe.dispatch = recording_route, recording_dispatch
        try:
            out = fn(*args, **kw)
        finally:
            moe.route, moe.dispatch = route, dispatch
        (r,) = routes
        return out, {k: t.cpu() for k, t in r.items()}

    def routing_gate(tag, cfg, r_cpu, r_card):
        """Tokens whose routing (the top k experts in order, and which of
        their pairs the capacity keeps) differs between the devices; each
        must be a near-tie on the CPU (k-th and (k+1)-th probabilities within
        MC_TIE)."""
        t, k = r_cpu["top_e"].shape
        differs = ((r_cpu["top_e"] != r_card["top_e"]).any(1)
                   | (r_cpu["keep"].view(t, k) != r_card["keep"].view(t, k)).any(1))
        srt = torch.sort(r_cpu["probs"], dim=-1, descending=True).values
        tie = (srt[:, k - 1] - srt[:, k] <= MC_TIE) if k < cfg.n_experts else torch.zeros_like(
            differs)
        if bool((differs & ~tie).any()):
            raise AssertionError(f"run {tag}: {int((differs & ~tie).sum())} tokens route "
                                 f"differently on the card without a near-tie on the CPU")
        return differs

    def block_runs(tag, cfg):
        """``tag``C (card vs CPU) and ``tag``H (the handoff on the card)."""
        t0 = time.perf_counter()
        p_cpu = materialize(B.decoder_block_decl(cfg), SEED, device=cpu)
        p_card = tree_map(lambda t: t.to(dev), p_cpu)
        draw_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(p_cpu))
        s_all = MC_PROMPT + MC_EXTRA
        x = torch.randn((MC_BATCH, s_all, cfg.d_model),
                        generator=torch.Generator().manual_seed(SEED))
        pos = torch.arange(s_all)
        worst = {"prefill": 0.0, "prefill_cache": 0.0, "aux": 0.0, "decode": 0.0,
                 "decode_cache": 0.0}
        skipped = 0
        t0 = time.perf_counter()
        (y, aux, cache), r_cpu = routed(B.decoder_block_forward, p_cpu, x[:, :MC_PROMPT],
                                        pos[:MC_PROMPT], cfg, collect_cache=True)
        cpu_s = time.perf_counter() - t0
        fa.LAUNCHES["flash_attention"] = 0
        (y_g, aux_g, cache_g), r_card = routed(
            B.decoder_block_forward, p_card, x[:, :MC_PROMPT].to(dev), pos[:MC_PROMPT].to(dev),
            cfg, collect_cache=True)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        if launches != 1:
            raise AssertionError(f"run {tag}C: K11 launched {launches} times for one block")
        differs = routing_gate(f"{tag}C prefill", cfg, r_cpu, r_card)
        skipped += int(differs.sum())
        rows = ~differs
        worst["prefill"] = rel_err(y_g.reshape(-1, cfg.d_model)[rows.to(dev)],
                                   y.reshape(-1, cfg.d_model)[rows])
        worst["prefill_cache"] = max(rel_err(cache_g[k], cache[k]) for k in cache)
        if not skipped:
            worst["aux"] = rel_err(aux_g, aux)
        cache = {k: torch.nn.functional.pad(c, (0, 0) * (c.ndim - 2) + (0, MC_EXTRA))
                 for k, c in cache.items()}
        for t in range(MC_PROMPT, s_all):
            on_card = {k: c.to(dev) for k, c in cache.items()}
            (o_g, on_card), r_card = routed(B.decoder_block_decode, p_card,
                                            x[:, t:t + 1].to(dev), on_card, t, cfg)
            (o, cache), r_cpu = routed(B.decoder_block_decode, p_cpu, x[:, t:t + 1], cache, t,
                                       cfg)
            differs = routing_gate(f"{tag}C decode", cfg, r_cpu, r_card)
            skipped += int(differs.sum())
            rows = ~differs
            worst["decode"] = max(worst["decode"], rel_err(
                o_g.reshape(-1, cfg.d_model)[rows.to(dev)], o.reshape(-1, cfg.d_model)[rows]))
            worst["decode_cache"] = max(worst["decode_cache"], *(
                rel_err(on_card[k][:, t], cache[k][:, t]) for k in cache))
        if not max(worst.values()) <= MC_RTOL:
            raise AssertionError(f"run {tag}C: card and CPU differ: {worst} > {MC_RTOL}")
        runs[f"{tag}C"] = dict(worst, skipped_near_ties=skipped, param_count=n_params,
                               n_experts=cfg.n_experts, top_k=cfg.top_k, batch=MC_BATCH,
                               prompt_len=MC_PROMPT, decode_steps=MC_EXTRA, draw_s=draw_s,
                               cpu_prefill_s=cpu_s, k11_launches=launches)
        log(f"[run {tag}C] one {cfg.arch_id} block at fp32 ({n_params} parameters, "
            f"{cfg.n_experts} experts top-{cfg.top_k}), card vs CPU over {MC_BATCH} x "
            f"{MC_PROMPT} tokens and {MC_EXTRA} decode steps, of max(1, max|x|): {worst}; "
            f"{skipped} near-tie tokens exempt; host draw {draw_s:.1f} s")
        # the handoff at a capacity where no pair is dropped (see QH above)
        hc = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        xg, full_pos = x.to(dev), pos.to(dev)
        y_full, _ = B.decoder_block_forward(p_card, xg, full_pos, hc)
        y_p, _, kv = B.decoder_block_forward(p_card, xg[:, :MC_PROMPT], full_pos[:MC_PROMPT],
                                             hc, collect_cache=True)
        scale = max(1.0, float(y_full.abs().max()))
        lh = {"prefill": float((y_p - y_full[:, :MC_PROMPT]).abs().max()) / scale,
              "decode": 0.0}
        kv = {k: torch.nn.functional.pad(c, (0, 0) * (c.ndim - 2) + (0, MC_EXTRA))
              for k, c in kv.items()}
        for t in range(MC_PROMPT, s_all):
            y_t, kv = B.decoder_block_decode(p_card, xg[:, t:t + 1], kv, t, hc)
            lh["decode"] = max(lh["decode"],
                               float((y_t - y_full[:, t:t + 1]).abs().max()) / scale)
        torch.cuda.synchronize()
        if not (lh["prefill"] <= LH_PREFILL_RTOL and lh["decode"] <= LH_DECODE_RTOL):
            raise AssertionError(f"run {tag}H: prefill {lh['prefill']} (limit "
                                 f"{LH_PREFILL_RTOL}), decode {lh['decode']} (limit "
                                 f"{LH_DECODE_RTOL})")
        runs[f"{tag}H"] = dict(lh, capacity_factor=hc.capacity_factor)
        log(f"[run {tag}H] the block's prefill of {MC_PROMPT} + {MC_EXTRA} decode steps against "
            f"its forward over {s_all} on the card (capacity factor "
            f"{hc.capacity_factor:.4g}): prefill {lh['prefill']:.3g}, decode "
            f"{lh['decode']:.3g} of max(1, max|x|)")
        del p_cpu, p_card

    block_runs("Q", replace(get_config(Q_ARCH), n_layers=1, n_experts=QC_EXPERTS,
                            dtype=torch.float32))
    block_runs("D", replace(get_config(DS_ARCH), n_layers=1, dtype=torch.float32))

    # ---- DP: the sharded round at world size 1, NCCL on the card, gloo on the CPU
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        group = fdist.make_client_mesh(1)
        fed = fedrf_paper.CLIENT
        opt = adam(fedrf_paper.PROTOCOL.lr)
        omega = make_omega(fed, device=cpu)
        start = init_params(fed, SEED, device=cpu)
        rng = np.random.default_rng(SEED)
        batches = [tuple(torch.tensor(a) for a in (
            rng.normal(size=(fed.input_dim, DP_BATCH)).astype(np.float32),
            rng.integers(0, fed.n_classes, size=DP_BATCH),
            rng.normal(size=(fed.input_dim, DP_BATCH)).astype(np.float32)))
            for _ in range(DP_ROUNDS)]
        states, round_ms = [], []
        for on_card in (False, True):
            d = dev if on_card else cpu
            rnd = fdist.build_sharded_round(group, fed, omega.to(d), opt)
            params = tree_map(lambda t: t.to(d), start)
            state = opt.init(params)
            for xb, yb, xt in batches:
                t0 = time.perf_counter()
                params, state, metrics = rnd(params, state, xb.to(d), yb.to(d), xt.to(d))
                if on_card:
                    torch.cuda.synchronize()
                    round_ms.append((time.perf_counter() - t0) * 1e3)
            states.append((params, metrics))
    finally:
        dist.destroy_process_group()
    (p_cpu, m_cpu), (p_card, m_card) = states
    dp_err = max(rel_err(a, b) for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)))
    if not dp_err <= DP_RTOL or not all(bool(torch.isfinite(t).all())
                                        for t in tree_leaves(p_card)):
        raise AssertionError(f"run DP: card vs CPU {dp_err} > {DP_RTOL}")
    runs["DP"] = dict(card_vs_cpu=dp_err, rounds=DP_ROUNDS, batch=DP_BATCH,
                      n_rff=fed.n_rff, m=fed.m, round_ms_p50=float(np.median(round_ms)),
                      l_c=float(m_card["l_c"]), l_mmd=float(m_card["l_mmd"]),
                      l_mmd_cpu=float(m_cpu["l_mmd"]))
    log(f"[run DP] the sharded round at world size 1 (its all-reduces identities: the round's "
        f"arithmetic, not the exchange between ranks), {DP_ROUNDS} rounds at fedrf_paper's width "
        f"(N = {fed.n_rff}, m = {fed.m}), NCCL on the card vs gloo on the CPU: {dp_err:.3g} of "
        f"max(1, max|leaf|); round p50 {runs['DP']['round_ms_p50']:.3f} ms on the card")
    return runs, k11_runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import mmd, rf_tca
    from repro_torch.core.kernels_math import (
        assemble_streamed_gram_ensemble, ell_vector, median_sigma,
    )
    from repro_torch.core.rff import draw_omega
    from repro_torch.data import make_domains
    from repro_torch.kernels import _build, ops, prng, rff
    from repro_torch.kernels import centered_gram as centered
    from repro_torch.kernels import rff_gram_stream as gram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    log(f"[card] {smi}")

    # ---- 1. build ---------------------------------------------------------
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} libraries in {secs:.1f} s")
    for name, out in _build.ptxas_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    torch.cuda.synchronize()

    # ---- data -------------------------------------------------------------
    t0 = time.perf_counter()
    doms = make_domains(2, N_S, dim=P, seed=SEED)
    xs = torch.tensor(np.ascontiguousarray(doms[0].x), device=dev)
    xt = torch.tensor(np.ascontiguousarray(doms[1].x[:, :N_T]), device=dev)
    x = torch.cat([xs, xt], dim=1).contiguous()
    ell = ell_vector(N_S, N_T, device=dev)
    sigma = median_sigma(x)
    torch.cuda.synchronize()
    log(f"[data] p={P} n_S={N_S} n_T={N_T} sigma={sigma:.6g} ({time.perf_counter() - t0:.1f} s)")

    report: dict[str, dict] = {}

    # ---- 2. K4 ------------------------------------------------------------
    worst_ulp, worst_abs = 0.0, 0.0
    for kind in ("gauss", "laplace"):
        for s, seed, e in ((1.0, 2**32 + 5, 3), (0.7, 17, 1), (sigma, 0, 0)):
            b = prng.threefry_bits(seed, 1024, P, row0=7, col0=3, ensemble_index=e, device=dev)
            bp = prng.threefry_bits_plain(seed, 1024, P, row0=7, col0=3, ensemble_index=e,
                                          device=dev)
            if not (torch.equal(b[0], bp[0]) and torch.equal(b[1], bp[1])):
                raise AssertionError(f"K4 bits differ ({kind}, seed {seed}, e {e})")
            kw = dict(ensemble_index=e, sigma=s, rf_kernel=kind, device=dev)
            om = prng.fused_omega(seed, 4096, P, **kw)
            op = prng.fused_omega_block_plain(seed, 4096, P, **kw)
            u, a = ulps(torch, om, op), float((om - op).abs().max())
            worst_ulp, worst_abs = max(worst_ulp, u), max(worst_abs, a)
            log(f"[K4] {kind} sigma={s:.4g} seed={seed} e={e}: bits equal, {u:.0f} ULP")
    if worst_ulp > OMEGA_ULP:
        raise AssertionError(f"K4 Omega {worst_ulp} ULP > {OMEGA_ULP}")
    torch.cuda.synchronize()
    om_kw = dict(sigma=sigma, device=dev)
    k4_ms = cuda_ms(torch, lambda: prng.fused_omega(SEED, 4096, P, **om_kw), 20)
    k4_plain = cuda_ms(torch, lambda: prng.fused_omega_block_plain(SEED, 4096, P, **om_kw), 5)
    b_ms, b_by = bound_ms(0.0, 4096 * P * 4, int_ops=4096 * P * THREEFRY_INT_OPS)
    report["K4"] = dict(
        name="threefry_omega", route="cuda",
        source="src/repro_torch/kernels/csrc/prng.cu",
        headers=["src/repro_torch/kernels/csrc/threefry.cuh"],
        replaces="src/repro/kernels/prng.py:48", max_abs_err=worst_abs, max_ulp=worst_ulp,
        tolerance=f"bits equal; {OMEGA_ULP} ULP", ms=k4_ms, plain_ms=k4_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, shape=f"Omega (4096, {P})",
    )
    log(f"[K4] (4096, {P}) kernel {k4_ms:.4f} ms, plain {k4_plain:.4f} ms")

    # ---- 3. K1 ------------------------------------------------------------
    n = x.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k1_row(xk, om):
        """K1 on (xk, om): its error from plain (gated), its time beside plain,
        torch.matmul and its bounds, and the split it ran with."""
        nf, w = om.shape[0], xk.shape[1]
        err = float((rff.rff(xk, om) - rff.rff_plain(xk, om)).abs().max())
        if not err <= RFF_ATOL:
            raise AssertionError(f"K1 N={nf} n={w}: max abs err {err} > {RFF_ATOL}")
        work = (2 * nf * P * w, (nf * P + P * w + 2 * nf * w) * 4)
        b_ms, b_by = bound_ms(*work, peak_flops=PEAK_SPLIT_TF32_FLOPS)
        row = dict(max_abs_err=err, ms=cuda_ms(torch, lambda: rff.rff(xk, om), 20),
                   plain_ms=cuda_ms(torch, lambda: rff.rff_plain(xk, om), 20),
                   library_ms=cuda_ms(torch, lambda: torch.matmul(om, xk), 20),
                   bound_ms=b_ms, bound_by=b_by, **product_bounds(*work),
                   slices=rff.split_plan(nf, P, w, sms=sms)["slices"])
        log(f"[K1] N={nf} p={P} n={w}: max abs err {err:.3g}; kernel {row['ms']:.4f} ms "
            f"({row['slices']} slices of p), plain {row['plain_ms']:.4f} ms, torch.matmul "
            f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms split-TF32 "
            f"({row['bound_fp32_ms']:.4f} fp32)")
        return row

    k1, k1_req = {}, {}
    for nf in (1000, 4096):
        om = prng.fused_omega(SEED, nf, P, sigma=sigma, device=dev)
        k1[nf] = k1_row(x, om)
        for w in K1_REQUEST_COLS:
            k1_req[f"N={nf} n={w}"] = k1_row(xt[:, :w].contiguous(), om)
        del om
    report["K1"] = dict(
        name="rff", route="cuda", source="src/repro_torch/kernels/csrc/rff.cu",
        headers=["src/repro_torch/kernels/csrc/featurize_tf32.cuh",
                 "src/repro_torch/kernels/csrc/hopper.cuh"],
        replaces="src/repro/kernels/rff.py:48", tolerance=f"atol {RFF_ATOL}",
        shape=f"N=4096 p={P} n={n}", **k1[4096],
        max_abs_err_all=max(r["max_abs_err"] for r in (*k1.values(), *k1_req.values())),
        n1000=k1[1000], requests=k1_req,
    )
    # a Cauchy Omega at the data's sigma: about half the phases reach |z| >= 64
    # and are recomputed as fp32's FMA chain from the operand
    nf = 1000
    om = draw_omega(SEED, nf, P, sigma=sigma, kernel="laplace", device=dev)
    cnt = torch.zeros(3, dtype=torch.int64, device=dev)
    sig_k = rff.rff(x, om, counters=cnt)
    drawn, recomputed, redrawn = cnt.tolist()
    if drawn or redrawn or not recomputed:
        raise AssertionError(f"K1 laplace: counters {cnt.tolist()}, expected only recomputed "
                             "phases")
    sig_p = rff.rff_plain(x, om)
    diff = (sig_k - sig_p).abs()
    res = dict(max_abs_err=float(diff.max()))
    z = om.double() @ x.double()
    sig_x = torch.cat([torch.cos(z), torch.sin(z)]) * rff.inv_sqrt(nf)
    del z
    plain_x = (sig_p.double() - sig_x).abs()
    res.update(kernel_vs_exact=float((sig_k.double() - sig_x).abs().max()),
               plain_vs_exact=float(plain_x.max()))
    # a phase under 64 summed from large terms cancels: there the split
    # products round at 2^-20 of sum_k |omega_k x_k| (tests/test_torch_cuda.py)
    terms = (om.abs() @ x.abs()) * (rff.inv_sqrt(nf) * 2.0 ** -20)
    past = diff > RFF_ATOL
    res.update(past_gate=int(past.sum()),
               past_gate_plain_within_gate_of_exact=int((past & (plain_x <= RFF_ATOL)).sum()),
               past_gate_and_rounding_bound=int((diff > RFF_ATOL + torch.cat([terms, terms]))
                                                .sum()))
    del sig_k, sig_p, sig_x, diff, plain_x, terms, past
    if res["past_gate_and_rounding_bound"]:
        raise AssertionError(f"K1 laplace: past 2e-5 plus the split products' rounding ({res})")
    if not res["max_abs_err"] <= RFF_ATOL:
        if res["plain_vs_exact"] <= RFF_ATOL:
            raise AssertionError(f"K1 laplace: {res['max_abs_err']} > {RFF_ATOL} from plain, "
                                 f"where the float64 answer is {res['plain_vs_exact']}")
        if not res["kernel_vs_exact"] <= res["plain_vs_exact"]:
            raise AssertionError(f"K1 laplace: farther from float64 than plain ({res})")
    res.update(ms=cuda_ms(torch, lambda: rff.rff(x, om), 10),
               plain_ms=cuda_ms(torch, lambda: rff.rff_plain(x, om), 10),
               recomputed_share=recomputed / (nf * n))
    report["K1"]["laplace"] = res
    log(f"[K1] laplace N={nf} p={P} n={n}: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, {100 * res['recomputed_share']:.2f} % of phases recomputed "
        f"(kernel's count); max abs err {res['max_abs_err']:.3g}, {res['past_gate']} elements "
        f"past {RFF_ATOL} ({res['past_gate_plain_within_gate_of_exact']} where plain is within "
        f"it of float64); from float64: kernel {res['kernel_vs_exact']:.3g}, plain "
        f"{res['plain_vs_exact']:.3g}")
    del om
    torch.cuda.synchronize()

    # ---- 4. fused Gram ----------------------------------------------------
    gram_err, gram_edges = {}, []

    def gram_errs(g, u, g_ref, u_ref):
        return dict(G_H=float((g - g_ref).abs().max()) / float(g_ref.abs().max()),
                    u=float((u - u_ref).abs().max()))

    def gram_exact(xg, lg, oms, inv):
        """(G_H, u) in float64 from the same Omega draws ``oms`` and scale."""
        xd, ld = xg.double(), lg.double()
        cs, ss = [], []
        for om in oms:
            z = om.double() @ xd
            cs.append(torch.cos(z) * inv)
            ss.append(torch.sin(z) * inv)
        mom = [torch.stack([m for b in blocks for m in (b @ ld, b.sum(dim=1))], dim=1)
               for blocks in (cs, ss)]
        c, s = torch.cat(cs, dim=1), torch.cat(ss, dim=1)
        return assemble_streamed_gram_ensemble(c @ c.T, c @ s.T, s @ s.T, *mom, n=xg.shape[1],
                                               ensemble=len(oms))

    def gram_gate(what, five_k, five_p, exact, ng, draws, report_exact):
        """The gate on the assembled (G_H, u) against plain; on a metric past
        it, the float64 answer (``exact()``) must be past it too and the
        kernel no farther from that than plain.  ``report_exact`` reports
        both distances from the float64 answer always."""
        g_k, u_k = assemble_streamed_gram_ensemble(*five_k, n=ng, ensemble=draws)
        g_p, u_p = assemble_streamed_gram_ensemble(*five_p, n=ng, ensemble=draws)
        res = gram_errs(g_k, u_k, g_p, u_p)
        over = [m for m in ("G_H", "u") if not res[m] <= GRAM_ATOL]
        if over or report_exact:
            g_x, u_x = exact()
            kx, px = gram_errs(g_k, u_k, g_x, u_x), gram_errs(g_p, u_p, g_x, u_x)
            for m in ("G_H", "u"):
                res[f"{m}_kernel_vs_exact"], res[f"{m}_plain_vs_exact"] = kx[m], px[m]
        if over:
            log(f"[gram] {what}: past {GRAM_ATOL} of plain, against float64 {res}")
            for m in over:
                if px[m] <= GRAM_ATOL:
                    raise AssertionError(f"{what}: {m} {res[m]} > {GRAM_ATOL} from plain, where "
                                         f"the float64 answer is {px[m]} from plain")
                if not kx[m] <= px[m]:
                    raise AssertionError(f"{what}: {m} farther from float64 than plain ({res})")
        return res

    def ell_of(ng):
        return ell if ng == n else ell_vector(ng // 2, ng - ng // 2, device=dev)

    def fused_gram_check(xg, nf, draws, sig, exact=False):
        ng, lg = xg.shape[1], ell_of(xg.shape[1])
        kw = dict(n_features=nf, seed=SEED, ensemble=draws, sigma=sig)

        def exact_answer():
            oms = [prng.fused_omega_block_plain(SEED, nf, xg.shape[0], ensemble_index=e,
                                                sigma=sig, device=dev) for e in range(draws)]
            return gram_exact(xg, lg, oms, gram.feature_scale(nf, draws))

        return gram_gate(f"fused Gram N={nf} S={draws} p={xg.shape[0]} n={ng} sigma={sig:.4g}",
                         gram.rff_gram_stream_fused(xg, lg, **kw),
                         gram.rff_gram_stream_fused_plain(xg, lg, **kw), exact_answer,
                         ng, draws, exact)

    def operand_gram_check(xg, om, what, exact=False):
        ng, lg = xg.shape[1], ell_of(xg.shape[1])
        return gram_gate(f"operand Gram {what}", gram.rff_gram_stream(xg, om, lg),
                         gram.rff_gram_stream_plain(xg, om, lg),
                         lambda: gram_exact(xg, lg, [om], gram.feature_scale(om.shape[0], 1)),
                         ng, 1, exact)

    for nf, draws in ((1000, 1), (1000, 4), (4096, 1), (4096, 4)):
        block = gram.gram_tile_plan(nf, n=n, ensemble=draws)["block"]
        res = fused_gram_check(x, nf, draws, sigma)
        gram_err[(nf, draws)] = max(res["G_H"], res["u"])
        log(f"[gram] N={nf} S={draws} block={block}: G_H/max {res['G_H']:.3g}, u {res['u']:.3g}")
    for nf, draws, pe, ne in FUSED_GRAM_EDGES:
        xe = xt[:pe, :ne].contiguous()
        for sig in (sigma, median_sigma(xe)):
            res = fused_gram_check(xe, nf, draws, sig, exact=True)
            gram_edges.append(dict(N=nf, S=draws, p=pe, n=ne, sigma=sig, **res))
            log(f"[gram] edge N={nf} S={draws} p={pe} n={ne} sigma={sig:.4g}: G_H/max "
                f"{res['G_H']:.3g}, u {res['u']:.3g}; G_H from float64: kernel "
                f"{res['G_H_kernel_vs_exact']:.3g}, plain {res['G_H_plain_vs_exact']:.3g}")
    torch.cuda.synchronize()
    k5_kw = dict(n_features=1000, seed=SEED, ensemble=1, sigma=sigma)
    k5_same = all(torch.equal(a, b) for a, b in zip(gram.rff_gram_stream_fused(x, ell, **k5_kw),
                                                     gram.rff_gram_stream_fused(x, ell, **k5_kw)))
    log(f"[gram] two identical K5 calls bit-identical: {k5_same} (k split across blocks, "
        f"atomic adds)")

    def fused_counts(fn, **kw):
        """One check launch with the featurize's counters: (Omega elements
        drawn, phases recomputed as fp32's FMA chain, Omega elements that
        recompute drew)."""
        cnt = torch.zeros(3, dtype=torch.int64, device=dev)
        fn(counters=cnt, **kw)
        return cnt.tolist()

    for key, nf, draws in (("K5", 1000, 1), ("K6", 4096, 4)):
        kw = dict(n_features=nf, seed=SEED, ensemble=draws, sigma=sigma)
        plan = gram.gram_tile_plan(nf, n=n, ensemble=draws)
        drawn, recomputed, _ = fused_counts(gram.rff_gram_stream_fused, x=x, ell=ell, **kw)
        draws_per = drawn / (nf * P * draws)
        k_ms = cuda_ms(torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 3)
        p_ms = cuda_ms(torch, lambda: gram.rff_gram_stream_fused_plain(x, ell, **kw), 3)
        oms = [prng.fused_omega(SEED, nf, P, ensemble_index=e, sigma=sigma, device=dev)
               for e in range(draws)]
        w = torch.cat([torch.cat([torch.cos(o @ x), torch.sin(o @ x)]) for o in oms], dim=1)

        def library():
            for o in oms:
                torch.matmul(o, x)
            torch.matmul(w, w.T)

        lib_ms = cuda_ms(torch, library, 3)
        del oms, w
        flops = 2 * draws * nf * P * n + 2 * draws * n * (nf * nf + nf * (nf + 1))
        nbytes = (P * n + n + 3 * nf * nf + 4 * nf * draws) * 4
        int_ops = draws * nf * P * THREEFRY_INT_OPS
        bounds = product_bounds(flops, nbytes, int_ops)
        b_ms, b_by = bound_ms(flops, nbytes, int_ops, peak_flops=PEAK_SPLIT_TF32_FLOPS)
        report[key] = dict(
            name=f"rff_gram_stream_fused (N={nf}, S={draws})", route="cuda",
            source="src/repro_torch/kernels/csrc/rff_gram_stream_fused.cu",
            headers=["src/repro_torch/kernels/csrc/featurize_tf32.cuh",
                     "src/repro_torch/kernels/csrc/gram_tf32.cuh",
                     "src/repro_torch/kernels/csrc/hopper.cuh",
                     "src/repro_torch/kernels/csrc/threefry.cuh"],
            replaces=("src/repro/kernels/rff_gram_stream.py:524" if key == "K5"
                      else "src/repro/kernels/rff_gram_stream.py:587"),
            max_abs_err=max(v for k, v in gram_err.items() if k[0] == nf),
            tolerance=f"atol {GRAM_ATOL} on G_H/max|G_H| and u", ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, **bounds, library_ms=lib_ms,
            shape=f"N={nf} S={draws} p={P} n={n} block={plan['block']}",
            draws_per_omega_element=draws_per, phases_recomputed=recomputed,
        )
        log(f"[gram] {key} N={nf} S={draws}: kernel {k_ms:.3f} ms, plain {p_ms:.2f} ms, "
            f"torch.matmul {lib_ms:.3f} ms, bound {b_ms:.3f} ms split-TF32 "
            f"({bounds['bound_fp32_ms']:.3f} fp32), Omega drawn {draws_per:g}x per element "
            f"(kernel's count), {recomputed} phases recomputed")
    report["K5"]["bit_identical_repeat"] = k5_same
    report["K5"]["edges"] = gram_edges

    def laplace_run(key, fn, plain, nf, draws, err, **kw):
        """``key`` with Cauchy draws at the main shape: time, plain time,
        the share of phases recomputed as fp32's FMA chain, the distance
        from plain (reported, not gated)."""
        kw.update(n_features=nf, seed=SEED, sigma=sigma, rf_kernel="laplace")
        drawn, recomputed, redrawn = fused_counts(fn, **kw)
        res = dict(ms=cuda_ms(torch, lambda: fn(**kw), 3),
                   plain_ms=cuda_ms(torch, lambda: plain(**kw), 3),
                   recomputed_share=recomputed / (nf * n * draws),
                   draws_per_omega_element=drawn / (nf * P * draws),
                   recompute_draws_per_omega_element=redrawn / (nf * P * draws),
                   **err(fn(**kw), plain(**kw)))
        report[key]["laplace"] = res
        log(f"[{key}] laplace N={nf} S={draws} p={P} n={n}: kernel {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, {100 * res['recomputed_share']:.2f} % of phases "
            f"recomputed (Omega redrawn {res['recompute_draws_per_omega_element']:g}x per "
            f"element), from plain {res}")

    laplace_run("K5", gram.rff_gram_stream_fused, gram.rff_gram_stream_fused_plain, 1000, 1,
                lambda a, b: gram_errs(*assemble_streamed_gram_ensemble(*a, n=n, ensemble=1),
                                       *assemble_streamed_gram_ensemble(*b, n=n, ensemble=1)),
                x=x, ell=ell, ensemble=1)
    torch.cuda.synchronize()

    # ---- 5. operand Gram (K2/K3), seed-fused featurize (K7), centered Gram (K8)
    operand_edges = []
    for nf, pe, ne in OPERAND_GRAM_EDGES:
        xe = xt[:pe, :ne].contiguous()
        for sig in (sigma, median_sigma(xe)):
            what = f"N={nf} p={pe} n={ne} sigma={sig:.4g}"
            res = operand_gram_check(xe, draw_omega(SEED, nf, pe, sigma=sig, device=dev), what,
                                     exact=True)
            operand_edges.append(dict(N=nf, p=pe, n=ne, sigma=sig, **res))
            log(f"[K2] edge {what}: G_H/max {res['G_H']:.3g}, u {res['u']:.3g}; G_H from "
                f"float64: kernel {res['G_H_kernel_vs_exact']:.3g}, plain "
                f"{res['G_H_plain_vs_exact']:.3g}")
    for key, nf in (("K2", 1000), ("K3", 4096)):
        om = draw_omega(SEED, nf, P, sigma=sigma, device=dev)
        res = operand_gram_check(x, om, f"N={nf}")
        eg, eu = res["G_H"], res["u"]
        block = gram.gram_tile_plan(nf, n=n)["block"]
        k_ms = cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 3)
        p_ms = cuda_ms(torch, lambda: gram.rff_gram_stream_plain(x, om, ell), 3)
        z = om @ x
        w = torch.cat([torch.cos(z), torch.sin(z)])
        del z
        lib_ms = cuda_ms(torch, lambda: (torch.matmul(om, x), torch.matmul(w, w.T)), 3)
        del w
        flops = 2 * nf * P * n + 2 * n * (nf * nf + nf * (nf + 1))
        nbytes = (nf * P + P * n + n + 3 * nf * nf + 4 * nf) * 4
        b_ms, b_by = bound_ms(flops, nbytes, peak_flops=PEAK_SPLIT_TF32_FLOPS)
        bounds = product_bounds(flops, nbytes)
        report[key] = dict(
            name=f"rff_gram_stream (Omega operand, N={nf})", route="cuda",
            source="src/repro_torch/kernels/csrc/rff_gram_stream_fused.cu",
            headers=["src/repro_torch/kernels/csrc/featurize_tf32.cuh",
                     "src/repro_torch/kernels/csrc/gram_tf32.cuh",
                     "src/repro_torch/kernels/csrc/hopper.cuh"],
            replaces=("src/repro/kernels/rff_gram_stream.py:244" if key == "K2"
                      else "src/repro/kernels/rff_gram_stream.py:180"),
            max_abs_err=max(eg, eu), tolerance=f"atol {GRAM_ATOL} on G_H/max|G_H| and u",
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, **bounds, library_ms=lib_ms,
            shape=f"N={nf} p={P} n={n} block={block}",
        )
        log(f"[{key}] N={nf}: G_H/max {eg:.3g}, u {eu:.3g}; kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound {b_ms:.3f} ms split-TF32 "
            f"({bounds['bound_fp32_ms']:.3f} fp32)")
        del om
    report["K2"]["edges"] = operand_edges
    # K2 with a Cauchy Omega at the data's sigma: about half the phases reach
    # |z| >= 64 and are recomputed as fp32's FMA chain from the operand
    nf = 1000
    om = draw_omega(SEED, nf, P, sigma=sigma, kernel="laplace", device=dev)
    res = operand_gram_check(x, om, f"N={nf} laplace", exact=True)
    cnt = torch.zeros(3, dtype=torch.int64, device=dev)
    gram.rff_gram_stream(x, om, ell, counters=cnt)
    drawn, recomputed, redrawn = cnt.tolist()
    if drawn or redrawn or not recomputed:
        raise AssertionError(f"K2 laplace: counters {cnt.tolist()}, expected only recomputed "
                             "phases")
    res.update(ms=cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 3),
               plain_ms=cuda_ms(torch, lambda: gram.rff_gram_stream_plain(x, om, ell), 3),
               recomputed_share=recomputed / (nf * n))
    report["K2"]["laplace"] = res
    log(f"[K2] laplace N={nf} p={P} n={n}: kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, {100 * res['recomputed_share']:.2f} % of phases recomputed "
        f"(kernel's count); G_H/max {res['G_H']:.3g}, u {res['u']:.3g}; G_H from float64: "
        f"kernel {res['G_H_kernel_vs_exact']:.3g}, plain {res['G_H_plain_vs_exact']:.3g}")
    del om
    torch.cuda.synchronize()

    k7_errs = {}
    for nf, pe, ne in ((4096, P, n),) + FUSED_K7_EDGES:
        xe = x if (pe, ne) == (P, n) else xt[:pe, :ne].contiguous()
        for sig in (sigma,) if xe is x or ne < 2 else (sigma, median_sigma(xe)):
            k7_kw = dict(n_features=nf, seed=SEED, ensemble_index=1, sigma=sig)
            err = float((rff.rff_fused(xe, **k7_kw)
                         - rff.rff_fused_plain(xe, **k7_kw)).abs().max())
            if not err <= RFF_ATOL:
                raise AssertionError(f"K7 N={nf} p={pe} n={ne} sigma={sig:.4g}: max abs err "
                                     f"{err} > {RFF_ATOL}")
            k7_errs[(nf, pe, ne, sig)] = err
            log(f"[K7] N={nf} p={pe} n={ne} sigma={sig:.4g}: max abs err {err:.3g}")
    nf = 4096
    k7_kw = dict(n_features=nf, seed=SEED, ensemble_index=1, sigma=sigma)
    om = prng.fused_omega(SEED, nf, P, ensemble_index=1, sigma=sigma, device=dev)
    k7_work = (2 * nf * P * n, (P * n + 2 * nf * n) * 4, nf * P * THREEFRY_INT_OPS)
    b_ms, b_by = bound_ms(*k7_work, peak_flops=PEAK_SPLIT_TF32_FLOPS)
    drawn, recomputed, _ = fused_counts(rff.rff_fused, x=x, **k7_kw)
    draws_per = drawn / (nf * P)
    if not draws_per <= -(-n // 1024):
        raise AssertionError(f"K7 drew each Omega element {draws_per}x > ceil(n / 1024)")
    report["K7"] = dict(
        name="rff_fused", route="cuda", source="src/repro_torch/kernels/csrc/rff.cu",
        headers=["src/repro_torch/kernels/csrc/featurize_tf32.cuh",
                 "src/repro_torch/kernels/csrc/hopper.cuh",
                 "src/repro_torch/kernels/csrc/threefry.cuh"],
        replaces="src/repro/kernels/rff.py:117", max_abs_err=k7_errs[(nf, P, n, sigma)],
        max_abs_err_edges=max(k7_errs.values()),
        tolerance=f"atol {RFF_ATOL}", ms=cuda_ms(torch, lambda: rff.rff_fused(x, **k7_kw), 10),
        plain_ms=cuda_ms(torch, lambda: rff.rff_fused_plain(x, **k7_kw), 5),
        bound_ms=b_ms, bound_by=b_by, **product_bounds(*k7_work),
        library_ms=cuda_ms(torch, lambda: torch.matmul(om, x), 10),
        shape=f"N={nf} p={P} n={n} ensemble_index=1", draws_per_omega_element=draws_per,
        phases_recomputed=recomputed,
    )
    log(f"[K7] N={nf}: kernel {report['K7']['ms']:.3f} ms, plain "
        f"{report['K7']['plain_ms']:.3f} ms, torch.matmul {report['K7']['library_ms']:.3f} ms,"
        f" bound {b_ms:.3f} ms split-TF32 ({report['K7']['bound_fp32_ms']:.3f} fp32), Omega "
        f"drawn {draws_per:g}x per element (kernel's count; ceil(n / 1024) = {-(-n // 1024)}), "
        f"{recomputed} phases recomputed")
    del om
    laplace_run("K7", rff.rff_fused, rff.rff_fused_plain, nf, 1,
                lambda a, b: dict(max_abs_err=float((a - b).abs().max())), x=x, ensemble_index=1)

    def centered_check(sig, what, exact=False):
        """K8's gate, G/max within 1e-5 of plain, or, where plain itself is
        past that from the float64 answer, the kernel no farther from it."""
        g_k = centered.centered_gram(sig)
        g_p = centered.centered_gram_plain(sig)
        if not torch.equal(g_k, g_k.T):
            raise AssertionError(f"K8 {what}: G is not symmetric")
        res = dict(G=float((g_k - g_p).abs().max() / g_p.abs().max()))
        if not res["G"] <= CENTERED_ATOL or exact:
            g_x = centered.centered_gram_plain(sig.double())
            scale = float(g_x.abs().max())
            res["G_kernel_vs_exact"] = float((g_k.double() - g_x).abs().max()) / scale
            res["G_plain_vs_exact"] = float((g_p.double() - g_x).abs().max()) / scale
        if not res["G"] <= CENTERED_ATOL:
            log(f"[K8] {what}: past {CENTERED_ATOL} of plain, against float64 {res}")
            if res["G_plain_vs_exact"] <= CENTERED_ATOL:
                raise AssertionError(f"K8 {what}: G/max {res['G']} > {CENTERED_ATOL} from plain,"
                                     f" where the float64 answer is {res['G_plain_vs_exact']}")
            if not res["G_kernel_vs_exact"] <= res["G_plain_vs_exact"]:
                raise AssertionError(f"K8 {what}: farther from float64 than plain ({res})")
        return res

    k8_edges = []
    for nf, pe, ne in K8_EDGES:
        xe = (x if ne > N_T else xt)[:pe, :ne].contiguous()
        sig = rff.rff(xe, draw_omega(SEED, nf, pe, sigma=sigma, device=dev))
        what = f"2N={2 * nf} p={pe} n={ne} sigma={sigma:.4g}"
        res = centered_check(sig, what, exact=True)
        k8_edges.append(dict(two_N=2 * nf, p=pe, n=ne, sigma=sigma, **res))
        log(f"[K8] edge {what}: G/max {res['G']:.3g}; from float64: kernel "
            f"{res['G_kernel_vs_exact']:.3g}, plain {res['G_plain_vs_exact']:.3g}")
    k8 = {}
    for nf in (1000, 4096):
        sig = rff.rff(x, draw_omega(SEED, nf, P, sigma=sigma, device=dev))
        rows = 2 * nf
        err = centered_check(sig, f"2N={rows}")["G"]
        c = sig - sig.mean(dim=1, keepdim=True)
        k8_work = (rows * (rows + 1) * n, (rows * n + rows * rows) * 4)
        b_ms, b_by = bound_ms(*k8_work, peak_flops=PEAK_SPLIT_TF32_FLOPS)
        k8[rows] = dict(
            max_abs_err=err, ms=cuda_ms(torch, lambda: centered.centered_gram(sig), 5),
            plain_ms=cuda_ms(torch, lambda: centered.centered_gram_plain(sig), 5),
            library_ms=cuda_ms(torch, lambda: torch.matmul(c, c.T), 5),
            bound_ms=b_ms, bound_by=b_by, **product_bounds(*k8_work),
        )
        if rows == 2000:
            k8[rows]["bit_identical_repeat"] = torch.equal(centered.centered_gram(sig),
                                                           centered.centered_gram(sig))
        del sig, c
        log(f"[K8] 2N={rows} n={n}: G/max {err:.3g}; kernel {k8[rows]['ms']:.3f} ms, plain "
            f"{k8[rows]['plain_ms']:.3f} ms, torch.matmul {k8[rows]['library_ms']:.3f} ms, "
            f"bound {b_ms:.3f} ms split-TF32 ({k8[rows]['bound_fp32_ms']:.3f} fp32)")
    log(f"[K8] two identical calls at 2N=2000 bit-identical: "
        f"{k8[2000]['bit_identical_repeat']} (k split across blocks, atomic adds)")
    report["K8"] = dict(
        name="centered_gram", route="cuda", source="src/repro_torch/kernels/csrc/centered_gram.cu",
        headers=["src/repro_torch/kernels/csrc/gram_tf32.cuh",
                 "src/repro_torch/kernels/csrc/hopper.cuh"],
        replaces="src/repro/kernels/centered_gram.py:38",
        tolerance=f"atol {CENTERED_ATOL} on G/max|G|", shape=f"2N=8192 n={n}",
        **{k: v for k, v in k8[8192].items()},
        max_abs_err_all=max(v["max_abs_err"] for v in k8.values()),
        small=dict(shape=f"2N=2000 n={n}", **k8[2000]), edges=k8_edges,
    )
    torch.cuda.synchronize()
    # the tensor-core kernels of K1-K3, K5-K8: registers, spills, HGMMA in the
    # SASS (featurize_tf32_kernel<false> draws Omega, <true> loads it; K1's
    # split over p ends in featurize_finish_kernel)
    for lib, key, entries in (("rff", "K7", ("featurize_tf32_kernelILb0",
                                             "featurize_tf32_kernelILb1",
                                             "featurize_finish_kernel")),
                              ("rff_gram_stream_fused", "K5",
                               ("featurize_tf32_kernelILb0", "featurize_tf32_kernelILb1",
                                "gram_tf32_kernel")),
                              ("centered_gram", "K8", ("gram_tf32_kernel",))):
        lines = ptxas_entries(_build.ptxas(lib), entries)
        hgmma = sum("HGMMA" in line for line in _build.sass(lib).splitlines())
        for line in lines:
            log(f"[{key}] ptxas {lib}: {line}")
        log(f"[{key}] {hgmma} HGMMA instructions in the SASS of the {lib} library")
        if hgmma == 0:
            raise AssertionError(f"{lib}: no HGMMA in the SASS: not on the tensor cores")
        if len(lines) != len(entries):
            raise AssertionError(f"{lib}: ptxas reported {lines} for the kernels {entries}")
        if any("0 bytes spill stores" not in line for line in lines):
            raise AssertionError(f"{lib}: a tensor-core kernel spills: {lines}")
        report[key][f"ptxas_{lib}"] = lines
        report[key][f"hgmma_{lib}"] = hgmma
    for key in ("K6", "K2", "K3"):
        for field in ("ptxas_rff_gram_stream_fused", "hgmma_rff_gram_stream_fused"):
            report[key][field] = report["K5"][field]
    for field in ("ptxas_rff", "hgmma_rff"):
        report["K1"][field] = report["K7"][field]

    # ---- 6. small fit: card vs the CPU plain path --------------------------
    small = dict(n_features=96, m=8, gamma=GAMMA, sigma=sigma, w_rf=f"fused:{SEED}",
                 ensemble=2)
    xs_s, xt_s = xs[:, :300].cpu(), xt[:, :200].cpu()
    st_c = rf_tca.rf_tca_fit(xs_s, xt_s, device="cpu", **small)
    st_g = rf_tca.rf_tca_fit(xs_s, xt_s, device=dev, **small)
    ev_err = float(((st_g.eigvals.cpu() - st_c.eigvals).abs() / st_c.eigvals.abs()).max())

    def proj(w):
        q, _ = torch.linalg.qr(w.double().cpu())
        return q @ q.T

    sub = float(torch.linalg.matrix_norm(proj(st_g.w_rf) - proj(st_c.w_rf), ord=2))
    if not (ev_err <= 1e-2 and sub <= 1e-3):
        raise AssertionError(f"small fit: eigvals rel {ev_err}, subspace {sub}")
    log(f"[small] card vs CPU plain: eigvals rel err {ev_err:.3g}, subspace {sub:.3g}")
    # the materialized Omega: one seed, one draw on every device
    for kind in ("gauss", "laplace"):
        for nf, s_om in ((1000, sigma), (4096, 0.7)):
            om_card = draw_omega(SEED, nf, P, sigma=s_om, kernel=kind, device=dev)
            if not torch.equal(om_card.cpu(), draw_omega(SEED, nf, P, sigma=s_om, kernel=kind,
                                                         device="cpu")):
                raise AssertionError(f"draw_omega {kind} N={nf}: the card's Omega differs from "
                                     f"the CPU's")
    del om_card
    log("[small] draw_omega (gauss, laplace; N 1000, 4096; sigma != 1): the card's Omega "
        "equals the CPU's bit for bit")
    torch.cuda.synchronize()

    # ---- 7. main path: fits + requests through the public entry points ---
    rng = np.random.default_rng(SEED)
    counters = {"prng": prng.LAUNCHES, "rff": rff.LAUNCHES, "gram": gram.LAUNCHES,
                "operand_gram": gram.OPERAND_LAUNCHES, "centered_gram": centered.LAUNCHES}
    fit_kw = dict(gamma=GAMMA, sigma=sigma, seed=SEED, device=dev)
    runs, states = {}, {}
    plan = (
        # tag, N, m, S, mode, solver, kernels that must launch
        ("A", 1000, 32, 1, "fused", "eigh",
         ("prng.fused_omega", "rff.rff", "rff.rff_fused", "gram.*")),
        ("B", 4096, 8, 4, "fused", "eigh",
         ("prng.fused_omega", "rff.rff", "rff.rff_fused", "gram.*")),
        ("C", 1000, 32, 1, "stream", "eigh", ("rff.rff", "operand_gram.*")),
        ("D", 4096, 8, 1, "stream", "lobpcg", ("rff.rff", "operand_gram.*")),
        ("E", 1000, 32, 1, "dense", "eigh", ("rff.rff", "centered_gram.*")),
    )
    for tag, nf, m, draws, mode, solver, needed in plan:
        sizes = rng.integers(64, 513, size=16)
        cols = [torch.tensor(rng.choice(N_T, size=int(s), replace=False), device=dev)
                for s in sizes]
        reqs = [xt[:, c].contiguous() for c in cols]
        for c in counters.values():
            for k in c:
                c[k] = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = {}
        if mode == "fused":
            state, _ = rf_tca.rf_tca_fit_with_stats(
                xs, xt, n_features=nf, m=m, w_rf=f"fused:{SEED}", ensemble=draws, **fit_kw)
        else:
            state = rf_tca.rf_tca_fit(xs, xt, n_features=nf, m=m, mode=mode, solver=solver,
                                      **fit_kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if mode == "dense":  # E's second solver on the same data and seed
            t1 = time.perf_counter()
            states["E_cholesky"] = rf_tca.rf_tca_fit(xs, xt, n_features=nf, m=m, mode=mode,
                                                     solver="cholesky", **fit_kw)
            torch.cuda.synchronize()
            extra["fit_cholesky_s"] = time.perf_counter() - t1
        outs, lat = [], []
        for r in reqs:
            t1 = time.perf_counter()
            outs.append(rf_tca.rf_tca_transform(state, r))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        # the client messages Sigma ell (paper eq. 2): a seed-fused client
        # holds only the seed, so its featurize is K7; otherwise K1 on Omega
        if mode == "fused":
            sig_s = ops.rff_fused(xs, n_features=nf, seed=SEED, sigma_rf=sigma)
            sig_t = ops.rff_fused(xt, n_features=nf, seed=SEED, sigma_rf=sigma)
        else:
            sig_s, sig_t = rff.rff(xs, state.omega), rff.rff(xt, state.omega)
        msg_s, msg_t = mmd.message(sig_s, 1.0), mmd.message(sig_t, -1.0)
        del sig_s, sig_t
        torch.cuda.synchronize()
        launches = {k: dict(c) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        for name in needed:
            group, kern = name.split(".")
            for k, cnt in launches[group].items():
                if kern in ("*", k) and cnt <= 0:
                    raise AssertionError(f"fit {tag}: kernel {group}.{k} was not launched")
        # checks of what came out
        vals = state.eigvals
        if not (torch.isfinite(state.w_rf).all() and torch.isfinite(vals).all()):
            raise AssertionError(f"fit {tag}: non-finite state")
        if tuple(state.w_rf.shape) != (2 * nf, m) or not bool((vals[:-1] >= vals[1:]).all()):
            raise AssertionError(f"fit {tag}: bad shape or eigenvalue order")
        whole = rf_tca.rf_tca_transform(state, torch.cat(reqs, dim=1))
        req_err = float((torch.cat(outs, dim=1) - whole).abs().max() / whole.abs().max())
        if not (torch.isfinite(whole).all() and req_err <= 1e-5):
            raise AssertionError(f"fit {tag}: requests differ from the whole by {req_err}")
        # RF-MMD from the messages: unaligned ||msg_S + msg_T||^2, and aligned
        # ||W_RF^T (msg_S + msg_T)||^2 (paper eq. 11)
        before = float(mmd.mmd_projected(torch.eye(2 * nf, device=dev), msg_s, msg_t))
        after = float(mmd.mmd_projected(state.w_rf, msg_s, msg_t))
        if not (np.isfinite(before) and np.isfinite(after)):
            raise AssertionError(f"fit {tag}: RF-MMD {before} -> {after}")
        # where the fit's time goes: the statistics pass and the solve, apart
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if mode == "fused":
            g_h, u = rf_tca.fused_streaming_gram(x, ell, n_features=nf, seed=SEED,
                                                 ensemble=draws, sigma=sigma)
        elif mode == "stream":
            g_h, u = rf_tca.streaming_gram(x, ell, state.omega)
        else:
            g_h, u = rf_tca._dense_gram(rff.rff(x, state.omega), ell)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rf_tca.solve_w_rf_gram(g_h, u, GAMMA, m, solver=solver, seed=SEED)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if draws == 1:  # the fit's moment u is Sigma ell, as the client messages give it
            u_err = float((u - (msg_s + msg_t)).abs().max())
            if not u_err <= GRAM_ATOL:
                raise AssertionError(f"fit {tag}: u differs from the messages by {u_err}")
        # scale-free alignment: discrepancy over spread, from the fit's (G_H, u)
        w = state.w_rf
        ratio_before = float(n * (u @ u) / torch.trace(g_h))
        ratio_after = float(n * ((w.T @ u) ** 2).sum() / torch.trace(w.T @ g_h @ w))
        if tag == "D":
            d_stats = (g_h, u)
        del g_h, u, w
        runs[tag] = dict(
            n_features=nf, m=m, ensemble=draws, mode=mode, solver=solver, fit_s=fit_s,
            stats_pass_s=t2 - t1, solve_s=t3 - t2, **extra,
            request_ms_p50=float(np.percentile(lat, 50)),
            request_ms_p99=float(np.percentile(lat, 99)),
            request_cols=int(sizes.sum()), request_rel_err=req_err,
            rf_mmd_unaligned=before, rf_mmd_aligned=after,
            mmd_over_spread_unaligned=ratio_before, mmd_over_spread_aligned=ratio_after,
            peak_bytes=int(peak), top_eigvals=[float(v) for v in vals[:4]], launches=launches,
        )
        log(f"[fit {tag}] {mode}/{solver} N={nf} m={m} S={draws}: fit {fit_s:.3f} s (stats "
            f"pass {t2 - t1:.3f} s, solve {t3 - t2:.3f} s), requests p50 "
            f"{runs[tag]['request_ms_p50']:.3f} ms p99 {runs[tag]['request_ms_p99']:.3f} ms, "
            f"RF-MMD {before:.4g} unaligned, {after:.4g} aligned (eq. 11); MMD/spread "
            f"{ratio_before:.4g} -> {ratio_after:.4g}; peak {peak / 2**30:.2f} GiB, "
            f"launches {launches}")
        states[tag] = state
        del outs, whole, msg_s, msg_t
        torch.cuda.synchronize()

    # ---- cross-checks between the runs ---------------------------------------
    def cosines(wa, wb):
        qa = torch.linalg.qr(wa.double()).Q
        qb = torch.linalg.qr(wb.double()).Q
        return torch.linalg.svdvals(qa.T @ qb)

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    cross = {}
    st_c, st_e, st_ch = states["C"], states["E"], states["E_cholesky"]
    if not torch.equal(st_c.omega, st_e.omega):
        raise AssertionError("fits C and E drew different Omega from one seed")
    cross["C_vs_E_eigvals_rel"] = rel(st_c.eigvals, st_e.eigvals)
    cross["E_cholesky_vs_eigh_eigvals_rel"] = rel(st_ch.eigvals, st_e.eigvals)
    cross["E_cholesky_vs_eigh_min_cos"] = float(cosines(st_ch.w_rf, st_e.w_rf).min())
    # D: the fit's LOBPCG stops by the reference's rule, a residual under
    # eps 10 2N (|Ax| + theta), about 1 % of |Ax| at 2N = 8192; its eigenvalues
    # are held to that residual.  The same (G_H, u) solved with
    # lobpcg_tol=LOBPCG_TIGHT_TOL is held to the reference's bounds.
    g_h, u = d_stats
    w9, v9 = rf_tca.solve_w_rf_gram(g_h, u, GAMMA, 9, solver="eigh")
    w_e, v_e = w9[:, :8], v9[:8]
    w_l, v_l = rf_tca.solve_w_rf_gram(g_h, u, GAMMA, 8, solver="lobpcg", seed=SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w_t, v_t = rf_tca.solve_w_rf_gram(g_h, u, GAMMA, 8, solver="lobpcg", seed=SEED,
                                      lobpcg_tol=LOBPCG_TIGHT_TOL, lobpcg_iters=300)
    torch.cuda.synchronize()
    cross["D_lobpcg_tight_solve_s"] = time.perf_counter() - t1
    cross["D_eigh_lambda8_lambda9"] = [float(v9[7]), float(v9[8])]
    cross["D_lobpcg_vs_eigh_eigvals_rel"] = rel(v_l, v_e)
    cross["D_lobpcg_vs_eigh_cos"] = [float(v) for v in cosines(w_l, w_e)]
    cross["D_lobpcg_tight_vs_eigh_eigvals_rel"] = rel(v_t, v_e)
    cross["D_lobpcg_tight_vs_eigh_min_cos"] = float(cosines(w_t, w_e).min())
    rule = 2 * float(torch.finfo(torch.float32).eps) * 10 * g_h.shape[0]
    del g_h, u, w9, d_stats
    log(f"[cross] {cross}")
    for name, value, limit in (
        ("C vs E eigenvalues", cross["C_vs_E_eigvals_rel"], MODES_RTOL),
        ("E cholesky vs eigh eigenvalues", cross["E_cholesky_vs_eigh_eigvals_rel"], CHOL_RTOL),
        ("E cholesky vs eigh subspace", 1 - cross["E_cholesky_vs_eigh_min_cos"], CHOL_COS),
        ("D lobpcg (reference stopping rule) vs eigh eigenvalues",
         cross["D_lobpcg_vs_eigh_eigvals_rel"], rule),
        ("D lobpcg (tight tol) vs eigh eigenvalues",
         cross["D_lobpcg_tight_vs_eigh_eigvals_rel"], LOBPCG_RTOL),
        ("D lobpcg (tight tol) vs eigh subspace",
         1 - cross["D_lobpcg_tight_vs_eigh_min_cos"], LOBPCG_COS),
    ):
        if not value <= limit:
            raise AssertionError(f"{name}: {value} > {limit}")

    # ---- 8. K10 ----------------------------------------------------------
    from repro_torch.kernels import quantize

    k10_err = 0.0
    for rows, d in K10_CHECK:
        for bits in (8, 4):
            g = torch.Generator(device=dev).manual_seed(rows * d + bits)
            xq = torch.randn((rows, d), generator=g, device=dev) * 3.0
            xq[0, : min(d, 5)] = 0.0
            uq = torch.rand((rows, d), generator=g, device=dev)
            qmax = quantize.qmax_of(bits)
            sc = quantize.quant_scale(xq, qmax)
            out = quantize.fake_quant(xq, uq, sc, qmax=qmax)
            plain = quantize.fake_quant_plain(xq, uq, sc, qmax=qmax)
            if not torch.equal(out, plain):
                raise AssertionError(f"K10 ({rows}, {d}) qint{bits}: kernel differs from plain "
                                     f"by {float((out - plain).abs().max())}")
            k10_err = max(k10_err, float((out - plain).abs().max()))
    log(f"[K10] {len(K10_CHECK)} shapes x qint8/qint4: bit for bit, max abs err {k10_err}")
    k10 = {}
    for rows, d in K10_TIMED:
        # back-to-back calls on one (x, u) would read them from the L2 cache:
        # the calls cycle through enough copies to overflow it several times
        nbytes = 12 * rows * d + 4 * rows
        g = torch.Generator(device=dev).manual_seed(rows + d)
        copies = []
        for _ in range(max(1, -(-L2_FLUSH_BYTES // nbytes))):
            xq = torch.randn((rows, d), generator=g, device=dev)
            copies.append((xq, torch.rand((rows, d), generator=g, device=dev),
                           quantize.quant_scale(xq, 127)))
        turn = itertools.cycle(copies)
        b_ms, b_by = bound_ms(6 * rows * d, nbytes)
        kt = timed(torch, lambda: quantize.fake_quant(*next(turn), qmax=127), 200)
        pt = timed(torch, lambda: quantize.fake_quant_plain(*next(turn), qmax=127), 100)
        del copies, turn
        k10[(rows, d)] = dict(ms=kt["ms"], host_ms=kt["host_ms"], queued=kt["queued"],
                              plain_ms=pt["ms"], plain_host_ms=pt["host_ms"],
                              plain_queued=pt["queued"], bound_ms=b_ms, bound_by=b_by)
        log(f"[K10] ({rows}, {d}) qint8: kernel {kt['ms']:.5f} ms on the card (host "
            f"{kt['host_ms']:.5f} ms a call, queued {kt['queued']}), plain {pt['ms']:.5f} ms "
            f"(host {pt['host_ms']:.5f}, queued {pt['queued']}), bound {b_ms:.5f} ms ({b_by})")
    big, small_k10 = k10[K10_TIMED[1]], k10[K10_TIMED[0]]
    report["K10"] = dict(
        name="fake_quant", route="cuda", source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:37", max_abs_err=k10_err,
        tolerance="bit for bit", shape=f"{K10_TIMED[1]} fp32, qint8", library_ms=None, **big,
        small=dict(shape=f"{K10_TIMED[0]} fp32, qint8", **small_k10),
    )
    counters["quantize"] = quantize.LAUNCHES
    torch.cuda.synchronize()

    # ---- 9. K9 -------------------------------------------------------------
    from repro_torch.fleet import Topology
    from repro_torch.kernels import segment_reduce as seg_k

    def k9_inputs(k, d, e, seed, *, uniform_edges):
        g = torch.Generator(device=dev).manual_seed(seed)
        v = torch.randn((k, d), generator=g, device=dev)
        if uniform_edges:  # the fleet's contiguous blocks
            seg = torch.as_tensor(Topology.uniform(k, e).segment_ids, device=dev)
        else:
            seg = torch.randint(0, e, (k,), generator=g, device=dev, dtype=torch.int32)
        w = (torch.rand((k,), generator=g, device=dev) < 0.8).float()  # participation masks
        return v, seg, w

    def k9_check(v, seg, w, e, out, what):
        plain = seg_k.segment_reduce_plain(v, seg, w, e)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(out), test(plain)):
                raise AssertionError(f"K9 {what}: non-finite positions differ from plain")
        ok = torch.isfinite(plain)
        if not ok.any():
            return 0.0
        err = float((out[ok] - plain[ok]).abs().max())
        tol = K9_RTOL * max(1.0, float(plain[ok].abs().max()))
        if not err <= tol:
            raise AssertionError(f"K9 {what}: kernel differs from plain by {err} > {tol}")
        return err

    k9_err = 0.0
    for k, d, e in K9_CHECK:
        v, seg, w = k9_inputs(k, d, e, k + d + e, uniform_edges=e < k and k == FL_K)
        k9_err = max(k9_err, k9_check(v, seg, w, e, seg_k.segment_reduce(v, seg, w, e),
                                      f"({k}, {d}) -> {e}"))
        zero = seg_k.segment_reduce(v, seg, torch.zeros_like(w), e)
        if not float(zero.abs().max()) == 0.0:
            raise AssertionError(f"K9 ({k}, {d}) -> {e}: zero weights gave nonzero sums")
    # the non-finite contract: a NaN or Inf in column d of one edge makes column
    # d NaN in every other edge, as the dense weighted-membership product does
    nf_v = torch.tensor([[1, 2, 3], [float("nan"), 5, 6], [7, 8, float("inf")], [1, 2, 3]],
                        device=dev)
    nf_seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    nf_w = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    k9_check(nf_v, nf_seg, nf_w, 2, seg_k.segment_reduce(nf_v, nf_seg, nf_w, 2), "NaN/Inf")
    v, seg, w = k9_inputs(FL_K, 1025, FL_EDGES, 5, uniform_edges=True)
    v[3, 5], v[FL_K - 3, 5] = float("nan"), float("inf")  # two edges, one column
    v[FL_K // 2, 900], v[FL_K - 1, 40] = -float("inf"), float("nan")
    k9_check(v, seg, w, FL_EDGES, seg_k.segment_reduce(v, seg, w, FL_EDGES), "NaN/Inf at FL")
    log(f"[K9] {len(K9_CHECK)} shapes within {K9_RTOL} x max(1, max|plain|), zero weights "
        f"exact, non-finite positions equal; max abs err {k9_err:.3g}")
    k9 = {}
    for k, d, e in K9_TIMED:
        nbytes = (k * d + 2 * k + e * d) * 4
        copies = [k9_inputs(k, d, e, i, uniform_edges=True)
                  for i in range(max(2, -(-L2_FLUSH_BYTES // nbytes)))]
        wms = [(seg_k.segment_reduce_plain(torch.eye(k, device=dev), s, w, e), v)
               for v, s, w in copies]
        turn, turn_lib = itertools.cycle(copies), itertools.cycle(wms)
        b_ms, b_by = bound_ms(2 * k * d, nbytes)
        kt = timed(torch, lambda: seg_k.segment_reduce(*next(turn), e), 50)
        pt = timed(torch, lambda: seg_k.segment_reduce_plain(*next(turn), e), 20)
        lt = timed(torch, lambda: torch.matmul(*next(turn_lib)), 20)
        del copies, wms, turn, turn_lib
        k9[(k, d, e)] = dict(ms=kt["ms"], host_ms=kt["host_ms"], queued=kt["queued"],
                             plain_ms=pt["ms"], library_ms=lt["ms"], bound_ms=b_ms, bound_by=b_by)
        log(f"[K9] ({k}, {d}) -> {e}: kernel {kt['ms']:.5f} ms (host {kt['host_ms']:.5f} ms a "
            f"call, queued {kt['queued']}), plain {pt['ms']:.5f} ms, torch.matmul "
            f"{lt['ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
    big_k9, small_k9 = k9[K9_TIMED[0]], k9[K9_TIMED[1]]
    report["K9"] = dict(
        name="segment_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:49", max_abs_err=k9_err,
        tolerance=f"{K9_RTOL} x max(1, max|plain|); equal non-finite positions",
        shape=f"({K9_TIMED[0][0]}, {K9_TIMED[0][1]}) fp32 into {K9_TIMED[0][2]} edges", **big_k9,
        small=dict(shape=f"({K9_TIMED[1][0]}, {K9_TIMED[1][1]}) into {K9_TIMED[1][2]}",
                   **small_k9),
    )
    counters["segment_reduce"] = seg_k.LAUNCHES
    torch.cuda.synchronize()

    # ---- 10. FedRF-TCA training through the trainer's entry points ---------
    from repro_torch.comm import wire
    from repro_torch.comm.netsim import TraceScenario
    from repro_torch.configs import fedrf_paper
    from repro_torch.federated import FedRFTCATrainer, ProtocolConfig, RoundPlan
    from repro_torch.robust import FaultConfig
    from repro_torch.utils.tree import tree_leaves, tree_map

    fed_cfg = fedrf_paper.CLIENT  # the width of src/repro/configs/fedrf_paper.py
    fed_kw = dict(n_rounds=FED_ROUNDS, t_c=fedrf_paper.PROTOCOL.t_c, warmup_rounds=FED_WARMUP,
                  lr=fedrf_paper.PROTOCOL.lr, drop_setting="III", seed=SEED)
    doms5 = make_domains(5, 400, shift=1.2, seed=3)

    # The first K10 call of each (shape, qmax) on the main path is kept, in
    # pinned host memory (an async copy: no sync, no device memory), and held
    # against the plain version after the run; the count stays the kernel
    # wrapper's own.
    k10_seen = {}
    k10_launch = quantize.fake_quant

    def pinned(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    def recording_fake_quant(x, u, scale, *, qmax):
        out = k10_launch(x, u, scale, qmax=qmax)
        key = (tuple(x.shape), qmax)
        if x.is_cuda and key not in k10_seen:
            k10_seen[key] = tuple(pinned(t) for t in (x, u, scale, out))
        return out

    def check_main_path_k10(tag):
        torch.cuda.synchronize()
        if not k10_seen:
            raise AssertionError(f"run {tag}: no K10 call was recorded")
        for (shape, qmax), host in sorted(k10_seen.items()):
            xq, uq, sc, out = (t.to(dev) for t in host)
            plain = quantize.fake_quant_plain(xq, uq, sc, qmax=qmax)
            if not torch.equal(out, plain):
                raise AssertionError(f"run {tag}: K10 {shape} qmax {qmax} differs from plain by "
                                     f"{float((out - plain).abs().max())}")
        calls = [f"{r}x{d} qmax {q}" for (r, d), q in sorted(k10_seen)]
        log(f"[K10] run {tag}: its {len(calls)} launch shapes bit for bit: {calls}")
        k10_seen.clear()
        return calls

    # the same for the first K9 call of each (K, D, E) on the main path
    k9_seen = {}
    k9_launch = seg_k.segment_reduce

    def recording_segment_reduce(values, seg_ids, weights, n_segments):
        out = k9_launch(values, seg_ids, weights, n_segments)
        key = (tuple(values.shape), n_segments)
        if values.is_cuda and key not in k9_seen:
            k9_seen[key] = tuple(pinned(t.contiguous()) for t in (values, seg_ids, weights, out))
        return out

    def check_main_path_k9(tag):
        torch.cuda.synchronize()
        if not k9_seen:
            raise AssertionError(f"run {tag}: no K9 call was recorded")
        err = 0.0
        for ((k, d), e), host in sorted(k9_seen.items()):
            v, sg, w, out = (t.to(dev) for t in host)
            err = max(err, k9_check(v, sg, w, e, out, f"run {tag} ({k}, {d}) -> {e}"))
        calls = [f"{k}x{d} -> {e}" for (k, d), e in sorted(k9_seen)]
        log(f"[K9] run {tag}: its {len(calls)} launch shapes agree with plain (max abs err "
            f"{err:.3g}): {calls}")
        k9_seen.clear()
        return calls

    def params_of(tr):
        return tree_leaves(tr.tgt_params) + [
            leaf for i in range(tr.k) for leaf in tree_leaves(tr._src_param(i))]

    def train_run(tag, sources, target, cfg=fed_cfg, device=dev, finite=True, **kw):
        """One trainer run; ``finite`` says whether its parameters must end
        finite (True) or must not (False: the mean rule under NaN faults)."""
        for c in counters.values():
            for k in c:
                c[k] = 0
        base = 0
        if device == dev:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()  # what earlier phases still hold
        t0 = time.perf_counter()
        tr = FedRFTCATrainer(sources, target, cfg, ProtocolConfig(**{**fed_kw, **kw}),
                             device=device)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        acc_warm = tr.evaluate()
        lat = []
        step = tr.round
        # two-tier runs: what the server would have ingested with K uplinks
        flat_ingress = {"moments": 0, "w_rf": 0, "classifier": 0}
        if tr.topology is not None:
            ingress = tr.account_ingress

            def counting_ingress(kind, members):
                members = list(members)
                flat_ingress[kind] += len(members) * wire.serialized_size(
                    kind, tr._specs[kind], tr.transport.codecs[kind])
                ingress(kind, members)

            tr.account_ingress = counting_ingress

        def timed_round(t):
            t1 = time.perf_counter()
            out = step(t)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            return out

        tr.round = timed_round  # train() calls self.round(t) once per round
        # the host's share of a round: drawing the K clients' numpy batches
        # and copying them to the device (batched engine only)
        batch_ms = []
        draw = tr._round_batch

        def timed_batch():
            t1 = time.perf_counter()
            out = draw()
            batch_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        tr._round_batch = timed_batch
        tr.train()
        acc = tr.evaluate()
        torch.cuda.synchronize()
        launches = {k: dict(c) for k, c in counters.items()}
        is_finite = all(bool(torch.isfinite(x).all()) for x in params_of(tr))
        if is_finite != finite:
            raise AssertionError(f"run {tag}: parameters {'not ' * finite}all finite")
        if not (0.0 <= acc_warm <= 1.0 and 0.0 <= acc <= 1.0):
            raise AssertionError(f"run {tag}: accuracy {acc_warm} -> {acc}")
        row = dict(
            engine=tr.proto.engine, transport=tr.proto.transport, codec=tr.resolved_codec,
            k=tr.k, warmup_rounds=tr.proto.warmup_rounds, rounds=len(lat), warmup_s=warm_s,
            round_ms_p50=float(np.percentile(lat, 50)), round_ms_p99=float(np.percentile(lat, 99)),
            acc_after_warmup=acc_warm, acc_end=acc, params_finite=is_finite,
            bytes_by_kind=dict(tr.comm.bytes_by_kind),
            messages_by_kind=dict(tr.comm.messages_by_kind),
            k10_launches=launches["quantize"]["fake_quant"],
            k9_launches=launches["segment_reduce"]["segment_reduce"],
            peak_bytes=(int(torch.cuda.max_memory_allocated()) - base) if device == dev else None,
            rule=tr.rule.name, client_chunk=tr.proto.client_chunk, launches=launches,
            batch_draw_ms_p50=float(np.percentile(batch_ms, 50)) if batch_ms else None,
        )
        if tr.topology is not None:
            row.update(edges=tr.topology.n_edges, edge_codec=tr.proto.edge_codec,
                       ingress_bytes=dict(tr.ingress_bytes), flat_ingress_bytes=flat_ingress,
                       edge_bytes_by_kind=dict(tr.edge_transport.log.bytes_by_kind),
                       edge_messages_by_kind=dict(tr.edge_transport.log.messages_by_kind))
        log(f"[run {tag}] {row['engine']}/{row['transport']}/{row['codec']} K={tr.k} "
            f"rule {row['rule']}: warm-up {warm_s:.3f} s, round p50 {row['round_ms_p50']:.3f} "
            f"ms p99 {row['round_ms_p99']:.3f} ms, target acc {acc_warm:.4f} -> {acc:.4f}, bytes "
            f"{row['bytes_by_kind']}, K10 launches {row['k10_launches']}, K9 launches "
            f"{row['k9_launches']}, peak {(row['peak_bytes'] or 0) / 2**20:.1f} MiB above the "
            f"run's start, batch draw p50 {row['batch_draw_ms_p50']} ms")
        if tr.topology is not None:
            log(f"[run {tag}] E={row['edges']} chunk {row['client_chunk']}: server ingress "
                f"{row['ingress_bytes']} against {flat_ingress} with K uplinks; edge log "
                f"{row['edge_bytes_by_kind']}")
        return tr, row

    wire_kw = dict(transport="wire", codec="qint8")
    quantize.fake_quant = recording_fake_quant
    seg_k.segment_reduce = recording_segment_reduce
    tr_f, runs["F"] = train_run("F", doms5[:4], doms5[4], engine="batched", **wire_kw)
    if runs["F"]["k10_launches"] <= 0:
        raise AssertionError("run F: K10 was not launched")
    cross["F_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("F")
    tr_g, runs["G"] = train_run("G", doms5[:4], doms5[4], engine="serial", **wire_kw)
    for key in ("bytes_by_kind", "messages_by_kind"):
        if runs["G"][key] != runs["F"][key]:
            raise AssertionError(f"run G: {key} {runs['G'][key]} != F's {runs['F'][key]}")
    cross["F_vs_G_byte_log_equal"] = True
    if k10_seen:
        raise AssertionError(f"run G launched K10: {sorted(k10_seen)}")
    full = TraceScenario([RoundPlan([0, 1, 2, 3], [0, 1, 2, 3], [0, 1, 2, 3])], cycle=True)
    tr_hb, runs["H_batched"] = train_run("H batched", doms5[:4], doms5[4], engine="batched",
                                         scenario=full)
    tr_hs, runs["H_serial"] = train_run("H serial", doms5[:4], doms5[4], engine="serial",
                                        scenario=full)
    h_err = max(float((a - b).abs().max()) for a, b in zip(params_of(tr_hb), params_of(tr_hs)))
    cross["H_batched_vs_serial_max_leaf_err"] = h_err
    if not h_err <= FED_LEAF_TOL:
        raise AssertionError(f"run H: batched and serial differ by {h_err} > {FED_LEAF_TOL}")
    # FT: H batched through the two-tier merges with E = K and the chunked map
    tr_ft, runs["FT"] = train_run("FT", doms5[:4], doms5[4], engine="batched", scenario=full,
                                  topology=Topology.singleton(4), client_chunk=2)
    ft_err = max(float((a - b).abs().max()) for a, b in zip(params_of(tr_ft), params_of(tr_hb)))
    cross["FT_vs_H_batched_max_leaf_err"] = ft_err
    if not ft_err <= FED_LEAF_TOL:
        raise AssertionError(f"run FT: differs from H batched by {ft_err} > {FED_LEAF_TOL}")
    for key in ("bytes_by_kind", "messages_by_kind"):
        if runs["FT"][key] != runs["H_batched"][key]:
            raise AssertionError(f"run FT: {key} {runs['FT'][key]} != H's")
    if runs["FT"]["k9_launches"] <= 0:
        raise AssertionError("run FT: K9 was not launched")
    cross["FT_k9_launch_shapes"] = check_main_path_k9("FT")
    h_params = [t.detach().clone() for t in params_of(tr_hb)]  # phase 13's AD reads them
    del tr_f, tr_g, tr_hb, tr_hs, tr_ft
    # R: every rule under NaN payload faults; the mean must end non-finite
    nan_faults = FaultConfig(corrupt_moments=0.5, corrupt_w_rf=0.5, corruption="nan")
    for rule in ROBUST_RULES:
        _, runs[f"R_{rule}"] = train_run(
            f"R {rule}", doms5[:4], doms5[4], engine="batched", scenario=full,
            warmup_rounds=R_WARMUP, n_rounds=R_ROUNDS, rule=rule, faults=nan_faults,
            finite=rule != "mean")
    cross["R_acc_end"] = {r: runs[f"R_{r}"]["acc_end"] for r in ROBUST_RULES}
    doms65 = make_domains(65, 400, shift=1.2, seed=3)
    _, runs["F64"] = train_run("F64", doms65[:64], doms65[64], engine="batched", **wire_kw)
    if runs["F64"]["k10_launches"] <= 0:
        raise AssertionError("run F64: K10 was not launched")
    cross["F64_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("F64")
    del doms65
    # FL: the fleet at scale, K = 1024 sources over 64 edges, qint8 on both tiers
    doms_fl = make_domains(FL_K + 1, 400, shift=1.2, seed=3)
    tr_fl, runs["FL"] = train_run(
        "FL", doms_fl[:FL_K], doms_fl[FL_K], engine="batched", warmup_rounds=FL_WARMUP,
        n_rounds=FL_ROUNDS, topology=Topology.uniform(FL_K, FL_EDGES), client_chunk=FL_CHUNK,
        edge_codec="qint8", **wire_kw)
    fl = runs["FL"]
    if fl["k9_launches"] <= 0 or fl["k10_launches"] <= 0:
        raise AssertionError(f"run FL: K9 {fl['k9_launches']}, K10 {fl['k10_launches']} launches")
    if not sum(fl["ingress_bytes"].values()) < sum(fl["flat_ingress_bytes"].values()):
        raise AssertionError(f"run FL: ingress {fl['ingress_bytes']} not below the flat "
                             f"{fl['flat_ingress_bytes']}")
    cross["FL_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("FL")
    cross["FL_k9_launch_shapes"] = check_main_path_k9("FL")
    del tr_fl  # doms_fl stays for phase 13's AL
    fused_cfg = dataclasses.replace(fed_cfg, rff_impl="fused")
    short = dict(cfg=fused_cfg, engine="batched", warmup_rounds=5, n_rounds=5, t_c=2)
    tr_sc, runs["S_card"] = train_run("S card", doms5[:4], doms5[4], **short)
    tr_sp, runs["S_cpu"] = train_run("S cpu", doms5[:4], doms5[4], device="cpu", **short)
    s_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(params_of(tr_sc),
                                                                 params_of(tr_sp)))
    cross["S_card_vs_cpu_max_leaf_err"] = s_err
    if not s_err <= FED_LEAF_TOL:
        raise AssertionError(f"run S: card and CPU differ by {s_err} > {FED_LEAF_TOL}")
    del tr_sc, tr_sp
    # FS: the fleet and robust branches on the card against the CPU
    fs = dict(short, topology=Topology.of_groups([[0, 1], [2, 3]]), client_chunk=2,
              rule="trimmed_mean",
              faults=FaultConfig(byzantine=(0,), byzantine_mode="scale", byzantine_scale=100.0))
    tr_fc, runs["FS_card"] = train_run("FS card", doms5[:4], doms5[4], **fs)
    tr_fp, runs["FS_cpu"] = train_run("FS cpu", doms5[:4], doms5[4], device="cpu", **fs)
    # At E = 2 the trimmed mean cannot trim the attacker's edge away: W_RF and
    # the classifier grow ~35x and ~100x (the reference does the same), and
    # so does any rounding difference (a 1e-6 perturbation of the CPU's own
    # start grows ~34x more than in S).  So the gate is round by round: both
    # trainers start each round from the CPU's state, and every leaf agrees
    # to FED_LEAF_TOL of max(1, max|leaf|).  The free runs' divergence is
    # reported beside the CPU's own under that perturbation.
    pairs = list(zip(params_of(tr_fc), params_of(tr_fp)))
    cross["FS_free_card_vs_cpu_max_leaf_err"] = max(float((a.cpu() - b).abs().max())
                                                    for a, b in pairs)
    cross["FS_max_abs_param"] = max(float(b.abs().max()) for _, b in pairs)
    fs_kw = {**fed_kw, **{k: v for k, v in fs.items() if k != "cfg"}}
    tr_pp = FedRFTCATrainer(doms5[:4], doms5[4], fused_cfg,
                            ProtocolConfig(**{**fs_kw, "warmup_rounds": 0}), device="cpu")
    g = torch.Generator().manual_seed(SEED)
    tr_pp._src_stack = tree_map(lambda t: t * (1 + 1e-6 * torch.randn(t.shape, generator=g)),
                                tr_pp._src_stack)
    tr_pp._warmup(fs_kw["warmup_rounds"])
    tr_pp.train()
    cross["FS_cpu_self_divergence_1e-6_start"] = max(
        float((a - b).abs().max()) for a, b in zip(params_of(tr_pp), params_of(tr_fp)))
    del tr_fc, tr_fp, tr_pp
    # round by round: the card starts every round from the CPU's state
    tr_c = FedRFTCATrainer(doms5[:4], doms5[4], fused_cfg, ProtocolConfig(**fs_kw), device=dev)
    tr_p = FedRFTCATrainer(doms5[:4], doms5[4], fused_cfg, ProtocolConfig(**fs_kw),
                           device="cpu")
    warm_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(params_of(tr_c),
                                                                    params_of(tr_p)))
    if not warm_err <= FED_LEAF_TOL:
        raise AssertionError(f"run FS: warm-up on the card and CPU differ by {warm_err}")
    worst = 0.0
    for t in range(1, fs_kw["n_rounds"] + 1):
        tr_c._src_stack, tr_c._src_opt_stack, tr_c.tgt_params, tr_c.tgt_opt = (
            tree_map(lambda x: x.to(dev), st)
            for st in (tr_p._src_stack, tr_p._src_opt_stack, tr_p.tgt_params, tr_p.tgt_opt))
        tr_c.round(t)
        tr_p.round(t)
        worst = max(worst, max(float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))
                               for a, b in zip(params_of(tr_c), params_of(tr_p))))
    torch.cuda.synchronize()
    del tr_c, tr_p
    cross["FS_warmup_card_vs_cpu_max_leaf_err"] = warm_err
    cross["FS_lockstep_max_leaf_err_over_max1_leaf"] = worst
    if not worst <= FED_LEAF_TOL:
        raise AssertionError(f"run FS: a round on the card and on the CPU from one state differ "
                             f"by {worst} of max(1, max|leaf|) > {FED_LEAF_TOL}")
    if runs["FS_card"]["k9_launches"] <= 0:
        raise AssertionError("run FS: K9 was not launched")
    cross["FS_k9_launch_shapes"] = check_main_path_k9("FS card")
    quantize.fake_quant = k10_launch
    seg_k.segment_reduce = k9_launch
    log(f"[cross] H batched vs serial {h_err:.3g}, FT vs H batched {ft_err:.3g}, S card vs CPU "
        f"{s_err:.3g}, FS round by round {cross['FS_lockstep_max_leaf_err_over_max1_leaf']:.3g} "
        f"(free runs {cross['FS_free_card_vs_cpu_max_leaf_err']:.3g}, the CPU against itself "
        f"{cross['FS_cpu_self_divergence_1e-6_start']:.3g})")

    # ---- 11. K11 ------------------------------------------------------------
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    k11_ptxas = ptxas_entries(_build.ptxas("flash_attention"))
    for line in k11_ptxas:
        log(f"[K11] ptxas {line}")
    if not k11_ptxas or any("0 bytes spill stores" not in line for line in k11_ptxas):
        log("[K11] a kernel spills (or ptxas reported none)")
    hgmma = sum("HGMMA" in line for line in _build.sass("flash_attention").splitlines())
    log(f"[K11] {hgmma} HGMMA instructions in the SASS of the flash_attention library")
    if hgmma == 0:
        raise AssertionError("K11: no HGMMA in the SASS: the bf16 path is not on wgmma")

    def bf16_ulp(x):
        """Spacing of bf16 numbers at |x| (8 significant bits)."""
        return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0**-126))) - 7)

    def k11_inputs(b, h, kv, s, d, dv, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, dv)))

    def k11_check(q, k, v, out, causal, window, what):
        """fp32: atol 2e-5; bf16: one bf16 ULP of the plain output plus the
        fp32 atol (an output near zero is a sum with cancellation: the fp32
        sums of kernel and plain differ by up to ~1e-6 there, more than a
        bf16 ULP of the result), and at most 3e-2 of max(1, max|plain|) (the
        model's activations reach tens, where a bf16 ULP is 0.125);
        non-finite positions equal."""
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(out), test(plain)):
                raise AssertionError(f"K11 {what}: non-finite positions differ from plain")
        ok = torch.isfinite(plain)
        err = (out.float() - plain.float()).abs()[ok]
        worst = float(err.max()) if err.numel() else 0.0
        if q.dtype == torch.float32:
            if not worst <= K11_F32_ATOL:
                raise AssertionError(f"K11 {what}: max abs err {worst} > {K11_F32_ATOL}")
            return worst
        if not bool((err <= bf16_ulp(plain)[ok] + K11_F32_ATOL).all()):
            raise AssertionError(f"K11 {what}: beyond one bf16 ULP of plain + {K11_F32_ATOL}")
        cap = K11_BF16_ATOL * max(1.0, float(plain.float()[ok].abs().max()))
        if not worst <= cap:
            raise AssertionError(f"K11 {what}: max abs err {worst} > {cap}")
        return worst

    def exact_attention(q, k, v, causal, window):
        """The plain version's math in float64, one batch row at a time."""
        s, g = q.shape[2], q.shape[1] // k.shape[1]
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
        if causal:
            keep &= i >= j
        if window:
            keep &= (i - j) < window
        rows = []
        for bi in range(q.shape[0]):
            sc = torch.einsum("hqd,hkd->hqk", q[bi].double(),
                              k[bi].double().repeat_interleave(g, 0)) / q.shape[-1] ** 0.5
            sc = torch.where(keep, sc, torch.full_like(sc, fa.NEG_INF))
            rows.append(torch.einsum("hqk,hkd->hqd", torch.softmax(sc, -1),
                                     v[bi].double().repeat_interleave(g, 0)))
            del sc
        return torch.stack(rows)

    def k11_check_model(q, k, v, out, causal, window, what):
        """A launch on the model's activations: the K11_CHECK gate against the
        plain version, unless the exact (float64) answer, rounded to bf16,
        itself fails that gate.  Such outputs cancel (|o| << |v|) beyond what
        fp32 scores resolve, so the gate then holds only an implementation
        that rounds as the plain version does; the kernel is instead held to
        be no farther from the exact answer than the plain version, in the
        gate's units (one bf16 ULP of the exact answer plus 2e-5), at its
        worst position.  Non-finite positions and the 3e-2 cap as always."""
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(out), test(plain)):
                raise AssertionError(f"K11 {what}: non-finite positions differ from plain")
        ok = torch.isfinite(plain)
        err = (out.float() - plain.float()).abs()[ok]
        res = dict(max_abs_err=float(err.max()) if err.numel() else 0.0)
        cap = K11_BF16_ATOL * max(1.0, float(plain.float()[ok].abs().max()))
        if not res["max_abs_err"] <= cap:
            raise AssertionError(f"K11 {what}: max abs err {res['max_abs_err']} > {cap}")
        res["kernel_vs_plain_gate_units"] = float(
            (err / (bf16_ulp(plain)[ok] + K11_F32_ATOL)).max())
        if res["kernel_vs_plain_gate_units"] <= 1.0:
            return res
        exact = exact_attention(q, k, v, causal, window)
        res["exact_vs_plain_gate_units"] = float(
            ((exact.to(torch.bfloat16).float() - plain.float()).abs()[ok]
             / (bf16_ulp(plain)[ok] + K11_F32_ATOL)).max())
        if res["exact_vs_plain_gate_units"] <= 1.0:
            raise AssertionError(f"K11 {what}: beyond one bf16 ULP of plain + {K11_F32_ATOL} "
                                 f"({res['kernel_vs_plain_gate_units']:.3g}), where the exact "
                                 f"answer is within it")
        unit = (bf16_ulp(exact) + K11_F32_ATOL)[ok]
        res["kernel_vs_exact_gate_units"] = float(((out.double() - exact).abs()[ok] / unit).max())
        res["plain_vs_exact_gate_units"] = float(((plain.double() - exact).abs()[ok] / unit).max())
        del exact
        if not res["kernel_vs_exact_gate_units"] <= res["plain_vs_exact_gate_units"]:
            raise AssertionError(f"K11 {what}: farther from the exact answer than plain ({res})")
        return res

    k11_err = {"float32": 0.0, "bfloat16": 0.0}
    for b, h, kv, s, d, dv, dt, causal, window in K11_CHECK:
        q, k, v = k11_inputs(b, h, kv, s, d, dv, getattr(torch, dt), b * h * s + d + window)
        what = f"({b}, {h}, {kv}, {s}, {d}, {dv}) {dt} causal={causal} window={window}"
        k11_err[dt] = max(k11_err[dt], k11_check(
            q, k, v, fa.flash_attention(q, k, v, causal=causal, window=window), causal, window,
            what))
    for b, h, kv, s, d, dv in K11_LARGE_V:
        q, k, v = k11_inputs(b, h, kv, s, d, dv, torch.bfloat16, b * h * s + d)
        v = (v.float() * K11_V_SCALE).to(torch.bfloat16)
        k11_err["bfloat16"] = max(k11_err["bfloat16"], k11_check(
            q, k, v, fa.flash_attention(q, k, v), True, 0,
            f"({b}, {h}, {kv}, {s}, {d}, {dv}) bf16 causal, v x {K11_V_SCALE}"))
    del q, k, v
    log(f"[K11] {len(K11_CHECK) + len(K11_LARGE_V)} shapes (v x {K11_V_SCALE} at "
        f"{K11_LARGE_V}): fp32 within {K11_F32_ATOL} (max abs err "
        f"{k11_err['float32']:.3g}), bf16 within one bf16 ULP of plain + {K11_F32_ATOL} (max "
        f"abs err "
        f"{k11_err['bfloat16']:.3g}), non-finite positions equal")

    def causal_pairs(s, window=0):
        """(query, key) pairs the causal (and window) mask keeps."""
        return sum(min(i + 1, window) if window else i + 1 for i in range(s))

    k11 = {}
    for b, h, kv, s, d, dv in (K11_SERVE, K11_HD128, K11_MLA, K11_Q, K11_DS):
        nbytes = (b * h * s * (d + dv) + b * kv * s * (d + dv)) * 2
        copies = [k11_inputs(b, h, kv, s, d, dv, torch.bfloat16, i)
                  for i in range(max(2, -(-L2_FLUSH_BYTES // nbytes)))]
        turn = itertools.cycle(copies)
        b_ms, b_by = bound_ms(2 * b * h * causal_pairs(s) * (d + dv), nbytes,
                              peak_flops=PEAK_BF16_FLOPS)
        kt = timed(torch, lambda: fa.flash_attention(*next(turn)), 20)
        pt = timed(torch, lambda: fa.flash_attention_plain(*next(turn)), 5)
        lt = timed(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            *next(turn), is_causal=True, enable_gqa=True), 20)
        del copies, turn
        k11[(b, h, kv, s, d, dv)] = dict(
            ms=kt["ms"], host_ms=kt["host_ms"], queued=kt["queued"], plain_ms=pt["ms"],
            library_ms=lt["ms"], bound_ms=b_ms, bound_by=b_by,
            tflops=2 * b * h * causal_pairs(s) * (d + dv) / kt["ms"] / 1e9,
            plan=fa.bf16_plan(b, h, kv, s, d, dv))
        log(f"[K11] ({b}, {h}, {kv}, {s}, {d}, {dv}) bf16 causal: kernel {kt['ms']:.4f} ms (host "
            f"{kt['host_ms']:.4f} ms a call, queued {kt['queued']}, "
            f"{k11[(b, h, kv, s, d, dv)]['tflops']:.2f} TFLOP/s), plain {pt['ms']:.4f} ms, "
            f"scaled_dot_product_attention {lt['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"bf16 tensor cores); plan {k11[(b, h, kv, s, d, dv)]['plan']}")
    report["K11"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:69", max_abs_err=max(k11_err.values()),
        max_abs_err_by_dtype=k11_err,
        tolerance=f"fp32 atol {K11_F32_ATOL}; bf16 one bf16 ULP of plain + {K11_F32_ATOL}, "
                  f"at most {K11_BF16_ATOL} x max(1, max|plain|); equal non-finite positions",
        shape=f"{K11_SERVE} bf16 causal", bound_peak="989 TFLOP/s bf16; 3.35 TB/s",
        library="torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        **k11[K11_SERVE], hd128=dict(shape=f"{K11_HD128} bf16 causal", **k11[K11_HD128]),
        mla=dict(shape=f"{K11_MLA} bf16 causal", **k11[K11_MLA]),
        qwen3_moe=dict(shape=f"{K11_Q} bf16 causal", **k11[K11_Q]),
        deepseek_v2_lite=dict(shape=f"{K11_DS} bf16 causal", **k11[K11_DS]),
        ptxas=k11_ptxas, hgmma=hgmma,
    )
    torch.cuda.synchronize()
    report["K11"]["phase_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---- 12. the LM serve path through serve.generate ---------------------
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models import blocks as B
    from repro_torch.models.layers import embed
    from repro_torch.models.model import layer_slice
    from torch.utils._python_dispatch import TorchDispatchMode

    # the first K11 launch on the main path is kept and held against the
    # plain version after the run; the count stays the wrapper's own
    k11_seen = []
    k11_launch = fa.flash_attention

    def recording_flash_attention(q, k, v, *, causal=True, window=0):
        out = k11_launch(q, k, v, causal=causal, window=window)
        if q.is_cuda and not k11_seen:
            k11_seen.append((tuple(pinned(t) for t in (q, k, v, out)), causal, window))
        return out

    def lm_prompts(batch, s, vocab):
        return torch.randint(0, vocab, (batch, s), generator=torch.Generator().manual_seed(SEED))

    fa.flash_attention = recording_flash_attention
    lm_cfg = get_config(LM_ARCH)
    lm = LM(lm_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    prompts = lm_prompts(L_BATCH, L_PROMPT, lm_cfg.vocab_size).to(dev)
    lm_runs = {}
    for tag in ("first", "warm"):
        fa.LAUNCHES["flash_attention"] = 0
        res = serve.generate(lm, params, prompts, L_GEN)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        if launches != lm_cfg.n_layers:
            raise AssertionError(f"run L ({tag}): K11 launched {launches} times, not once per "
                                 f"layer ({lm_cfg.n_layers})")
        toks = res["tokens"]
        if tuple(toks.shape) != (L_BATCH, L_GEN) or not bool(
                ((toks >= 0) & (toks < lm_cfg.vocab_size)).all()):
            raise AssertionError(f"run L ({tag}): tokens {tuple(toks.shape)} outside the vocab")
        if not all(bool(torch.isfinite(lg).all()) for lg in res["logits"]):
            raise AssertionError(f"run L ({tag}): non-finite logits")
        decode_s = sum(res["step_ms"]) / 1e3
        lm_runs[tag] = dict(
            prefill_s=res["prefill_s"], prefill_tokens_per_s=L_BATCH * L_PROMPT / res["prefill_s"],
            decode_step_ms_p50=float(np.percentile(res["step_ms"], 50)),
            decode_step_ms_p99=float(np.percentile(res["step_ms"], 99)),
            decode_tokens_per_s=L_BATCH * (L_GEN - 1) / decode_s, k11_launches=launches,
            sample=toks[0, :8].tolist())
    peak = torch.cuda.max_memory_allocated() - base
    # the card's own time for a warm prefill and a decode step, queued behind
    # a device-side sleep (the host's enqueue time apart): against the host
    # clock's step time this gives the device's idle share
    _, cache = lm.prefill(params, {"tokens": prompts})
    cache = serve.grow_cache(cache, L_GEN)
    tok = prompts[:, -1:]
    pf = timed(torch, lambda: lm.prefill(params, {"tokens": prompts}), 3)
    dc = timed(torch, lambda: lm.decode_step(params, cache, {"tokens": tok}, L_PROMPT), 10)

    class OpCount(TorchDispatchMode):
        """Counts the aten ops a call dispatches (views included)."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount() as ops_decode:
        lm.decode_step(params, cache, {"tokens": tok}, L_PROMPT)
    with OpCount() as ops_prefill:
        lm.prefill(params, {"tokens": prompts})
    del cache
    lm_device = dict(prefill_device_ms=pf["ms"], prefill_host_ms=pf["host_ms"],
                     prefill_queued=pf["queued"], decode_step_device_ms=dc["ms"],
                     decode_step_host_ms=dc["host_ms"], decode_step_queued=dc["queued"],
                     aten_ops_decode_step=ops_decode.n, aten_ops_prefill=ops_prefill.n)
    (q, k, v, out), causal, window = k11_seen[0]
    q, k, v, out = (t.to(dev) for t in (q, k, v, out))
    first_gate = k11_check_model(q, k, v, out, causal, window,
                                 f"run L first launch {tuple(q.shape)}")
    first_err = first_gate["max_abs_err"]
    del q, k, v, out, params, res, prompts
    k11_seen.clear()
    runs["L"] = dict(arch=LM_ARCH, dtype="bfloat16", n_layers=lm_cfg.n_layers, batch=L_BATCH,
                     prompt_len=L_PROMPT, gen=L_GEN, param_count=lm.param_count(),
                     param_bytes=param_bytes, init_s=init_s, peak_bytes=int(peak),
                     k11_first_launch_max_abs_err=first_err, **lm_device, **{
                         f"{k}_{tag}": v for tag, r in lm_runs.items() for k, v in r.items()})
    w = lm_runs["warm"]
    log(f"[run L] {LM_ARCH} bf16, {lm_cfg.n_layers} layers, {lm.param_count()} parameters, batch "
        f"{L_BATCH} x {L_PROMPT} prompt, {L_GEN} tokens: prefill "
        f"{lm_runs['first']['prefill_s']:.4f} s first, {w['prefill_s']:.4f} s warm "
        f"({w['prefill_tokens_per_s']:.1f} tokens/s); decode step p50 "
        f"{w['decode_step_ms_p50']:.3f} ms p99 {w['decode_step_ms_p99']:.3f} ms "
        f"({w['decode_tokens_per_s']:.1f} tokens/s); K11 {lm_cfg.n_layers} launches a prefill, "
        f"the first within tolerance ({first_err:.3g} from plain; in gate units "
        f"{ {k: round(x, 3) for k, x in first_gate.items() if k.endswith('units')} }); peak "
        f"{peak / 2**30:.2f} GiB above"
        f" the start; init {init_s:.2f} s; on the card a prefill takes "
        f"{pf['ms']:.3f} ms (host enqueue {pf['host_ms']:.3f} ms, queued {pf['queued']}) and a "
        f"decode step {dc['ms']:.3f} ms (host enqueue {dc['host_ms']:.3f} ms, queued "
        f"{dc['queued']}); aten ops dispatched: {ops_prefill.n} a prefill, {ops_decode.n} a "
        f"decode step")
    torch.cuda.synchronize()

    # LC: the same model at fp32, card against CPU from the same weights.  At
    # full depth the random-init stack is chaotic: activations reach ~1000 and
    # a 1e-7 relative perturbation of the weights moves the CPU's own logits
    # by O(max|logit|).  So the gate is layer by layer, as FS's is round by
    # round: every block runs on the card and the CPU from the CPU's input
    # (and, decoding, the CPU's cache), and each output, each K/V cache entry
    # and the logits agree within 1e-3 x max(1, max|x|).  The free runs
    # through serve.generate are reported beside the CPU's own divergence
    # under that perturbation.
    lc_cfg = replace(lm_cfg, dtype=torch.float32)
    lc = LM(lc_cfg)
    params_cpu = lc.init(SEED, device="cpu")
    params_card = tree_map(lambda t: t.to(dev), params_cpu)
    prompts = lm_prompts(LC_BATCH, LC_PROMPT, lc_cfg.vocab_size)
    fa.LAUNCHES["flash_attention"] = 0
    res_c = serve.generate(lc, params_card, prompts.to(dev), LC_GEN)
    torch.cuda.synchronize()
    lc_launches = fa.LAUNCHES["flash_attention"]
    if lc_launches != lc_cfg.n_layers:
        raise AssertionError(f"run LC: K11 launched {lc_launches} times")
    t0 = time.perf_counter()
    res_p = serve.generate(lc, params_cpu, prompts, LC_GEN)
    cpu_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(SEED)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=g)), params_cpu)
    res_n = serve.generate(lc, nudged, prompts, LC_GEN)
    del nudged

    def rel_err(a, b):  # |a - b| over max(1, max|b|), b the CPU's
        return float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))

    lc_run = dict(
        free_card_vs_cpu=max(rel_err(a, b) for a, b in zip(res_c["logits"], res_p["logits"])),
        free_cpu_vs_cpu_1e7_weights=max(rel_err(a, b) for a, b in zip(res_n["logits"],
                                                                      res_p["logits"])))
    del res_n
    worst = {"prefill_layers": 0.0, "prefill_cache": 0.0, "prefill_logits": 0.0,
             "decode_layers": 0.0, "decode_logits": 0.0}
    x = embed(params_cpu["embedding"], prompts)
    pos = torch.arange(LC_PROMPT)
    ks, vs = [], []
    for i in range(lc_cfg.n_layers):
        y, _, kv = B.decoder_block_forward(layer_slice(params_cpu["blocks"], i), x, pos, lc_cfg,
                                           collect_cache=True)
        y_g, _, kv_g = B.decoder_block_forward(layer_slice(params_card["blocks"], i), x.to(dev),
                                               pos.to(dev), lc_cfg, collect_cache=True)
        worst["prefill_layers"] = max(worst["prefill_layers"], rel_err(y_g, y))
        worst["prefill_cache"] = max(worst["prefill_cache"], rel_err(kv_g["k"], kv["k"]),
                                     rel_err(kv_g["v"], kv["v"]))
        ks.append(kv["k"])
        vs.append(kv["v"])
        x = y
    logits = lc._last_logits(params_cpu, x)
    logits_g = lc._last_logits(params_card, x.to(dev))
    worst["prefill_logits"] = rel_err(logits_g, logits)
    cache = serve.grow_cache({"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}, LC_GEN)
    del ks, vs
    ties = 0
    for step in range(LC_GEN):
        if step:  # decode the CPU's pick of the step before, layer by layer
            x = embed(params_cpu["embedding"], picks[:, None])
            t = LC_PROMPT + step - 1
            for i in range(lc_cfg.n_layers):
                layer = layer_slice(cache["layers"], i)
                on_card = {k: c.to(dev) for k, c in layer.items()}
                y_g, _ = B.decoder_block_decode(layer_slice(params_card["blocks"], i), x.to(dev),
                                                on_card, t, lc_cfg)
                y, _ = B.decoder_block_decode(layer_slice(params_cpu["blocks"], i), x, layer, t,
                                              lc_cfg)
                worst["decode_layers"] = max(worst["decode_layers"], rel_err(y_g, y))
                x = y
            logits = lc._decode_logits(params_cpu, x)
            logits_g = lc._decode_logits(params_card, x.to(dev))
            worst["decode_logits"] = max(worst["decode_logits"], rel_err(logits_g, logits))
        tol = LC_RTOL * max(1.0, float(logits.abs().max()))
        top2 = torch.topk(logits[:, :lc_cfg.vocab_size], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        ties += int((~clear).sum())
        picks = torch.argmax(logits[:, :lc_cfg.vocab_size], dim=-1)
        picks_g = torch.argmax(logits_g[:, :lc_cfg.vocab_size], dim=-1).cpu()
        if not torch.equal(picks[clear], picks_g[clear]):
            raise AssertionError(f"run LC step {step}: greedy picks differ where the CPU's "
                                 f"top-two gap exceeds {tol}")
    lc_run.update(worst, near_ties=ties, cpu_s=cpu_s, k11_launches=lc_launches,
                  batch=LC_BATCH, prompt_len=LC_PROMPT, gen=LC_GEN)
    if not max(worst.values()) <= LC_RTOL:
        raise AssertionError(f"run LC: card and CPU differ layer by layer: {worst} > {LC_RTOL}")
    runs["LC"] = lc_run
    log(f"[run LC] fp32, card vs CPU layer by layer from the CPU's state, of max(1, max|x|): "
        f"{worst}; greedy picks equal ({ties} near-ties exempt). Free runs: card vs CPU "
        f"{lc_run['free_card_vs_cpu']:.3g}, the CPU against itself under 1e-7 weight noise "
        f"{lc_run['free_cpu_vs_cpu_1e7_weights']:.3g}; CPU generate {cpu_s:.1f} s")

    # LH: the prefill -> decode handoff on the card (tests/test_models.py:141-161),
    # layer by layer for the reason above: each block's prefill over LC_PROMPT
    # tokens and its LH_EXTRA decode steps from the collected (grown) cache
    # against the same block's forward over all of them, from forward's input
    toks = lm_prompts(LC_BATCH, LC_PROMPT + LH_EXTRA, lc_cfg.vocab_size).to(dev)
    fa.LAUNCHES["flash_attention"] = 0
    x = embed(params_card["embedding"], toks)
    full_pos = torch.arange(LC_PROMPT + LH_EXTRA, device=dev)
    lh = {"prefill": 0.0, "decode": 0.0}
    for i in range(lc_cfg.n_layers):
        lp = layer_slice(params_card["blocks"], i)
        y, _ = B.decoder_block_forward(lp, x, full_pos, lc_cfg)
        y_p, _, kv = B.decoder_block_forward(lp, x[:, :LC_PROMPT], full_pos[:LC_PROMPT], lc_cfg,
                                             collect_cache=True)
        scale = max(1.0, float(y.abs().max()))
        lh["prefill"] = max(lh["prefill"],
                            float((y_p - y[:, :LC_PROMPT]).abs().max()) / scale)
        # room for the decode steps on this layer's (b, s, kv, hd) cache
        kv = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, LH_EXTRA)) for k, c in kv.items()}
        for t in range(LC_PROMPT, LC_PROMPT + LH_EXTRA):
            y_t, kv = B.decoder_block_decode(lp, x[:, t:t + 1], kv, t, lc_cfg)
            lh["decode"] = max(lh["decode"], float((y_t - y[:, t:t + 1]).abs().max()) / scale)
        x = y
    torch.cuda.synchronize()
    lh["k11_launches"] = fa.LAUNCHES["flash_attention"]
    if not (lh["prefill"] <= LH_PREFILL_RTOL and lh["decode"] <= LH_DECODE_RTOL):
        raise AssertionError(f"run LH: prefill {lh['prefill']} (limit {LH_PREFILL_RTOL}), "
                             f"decode {lh['decode']} (limit {LH_DECODE_RTOL})")
    runs["LH"] = lh
    log(f"[run LH] fp32, each block's prefill of {LC_PROMPT} + {LH_EXTRA} decode steps against "
        f"its forward over {LC_PROMPT + LH_EXTRA}: prefill {lh['prefill']:.3g}, decode "
        f"{lh['decode']:.3g} of max(1, max|x|)")
    del params_cpu, params_card, res_c, res_p, cache, x, y
    fa.flash_attention = k11_launch
    report["K11"]["launches"] = runs["L"]["k11_launches_first"]
    report["K11"]["launches_by_run"] = {"L_first": runs["L"]["k11_launches_first"],
                                        "L_warm": runs["L"]["k11_launches_warm"],
                                        "LC": lc_launches, "LH": lh["k11_launches"]}
    report["K11"]["first_launch_max_abs_err"] = first_err
    report["K11"]["first_launch_gate"] = first_gate
    torch.cuda.synchronize()
    runs["L"]["phase_12_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 11 (K11) {report['K11']['phase_s']:.1f} s, phase 12 (L, LC, LH) "
        f"{runs['L']['phase_12_s']:.1f} s")

    # ---- 13. the async runtime (fedsim) through AsyncScheduler.run ----------
    import tempfile
    from types import SimpleNamespace

    from repro_torch.comm.netsim import LinkModel, LinkScenario
    from repro_torch.federated.engine import BatchedRoundEngine
    from repro_torch.fedsim import AsyncConfig, AsyncScheduler, markov_trace

    t_phase = time.perf_counter()
    quantize.fake_quant = recording_fake_quant
    seg_k.segment_reduce = recording_segment_reduce

    def history_rows(hist):
        return [{k: v for k, v in h.to_dict().items() if k != "acc"} for h in hist]

    def leaf_err(tr, ref):
        """max over leaves of |a - b| / max(1, max|b|), ``ref`` a list of leaves."""
        return max(float((a.cpu() - b.cpu()).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(params_of(tr), ref))

    def async_run(tag, sources, target, acfg, *, flushes, cfg=fed_cfg, device=dev, start=None,
                  links=None, availability=None, edge_links=None, **kw):
        """One ``AsyncScheduler(...).run(flushes)``; ``start`` (a checkpoint
        directory) gives the trainer its state, and a card trainer started so
        takes its channel draws from the CPU's generator (the card's draws
        other numbers)."""
        for c in counters.values():
            for k in c:
                c[k] = 0
        on_card = torch.device(device).type == "cuda"
        base = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = FedRFTCATrainer(sources, target, cfg, ProtocolConfig(**{**fed_kw, **kw}),
                             device=device)
        if start is not None:
            tr.restore_state(start)
            if on_card and tr._engine.channel:
                shim = SimpleNamespace(channel_seed=tr._engine.channel_seed,
                                       device=torch.device("cpu"))
                tr._engine.channel_uniforms = lambda *a: BatchedRoundEngine.channel_uniforms(
                    shim, *a).to(device)
        if on_card:
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        acc_warm = tr.evaluate()
        flat_ingress = {"moments": 0, "w_rf": 0, "classifier": 0}
        if tr.topology is not None:
            ingress = tr.account_ingress

            def counting_ingress(kind, members):
                members = list(members)
                flat_ingress[kind] += len(members) * wire.serialized_size(
                    kind, tr._specs[kind], tr.transport.codecs[kind])
                ingress(kind, members)

            tr.account_ingress = counting_ingress
        sched = AsyncScheduler(tr, acfg, availability=availability, links=links,
                               edge_links=edge_links)
        lat = []
        flush = sched._flush

        def timed_flush(t, entries):
            t1 = time.perf_counter()
            row = flush(t, entries)
            if on_card:
                torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            return row

        sched._flush = timed_flush
        t1 = time.perf_counter()
        hist = sched.run(flushes)
        if on_card:
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        acc = tr.evaluate()
        launches = {k: dict(c) for k, c in counters.items()}
        if not all(bool(torch.isfinite(x).all()) for x in params_of(tr)):
            raise AssertionError(f"run {tag}: parameters not all finite")
        if sched.flushes != flushes:
            raise AssertionError(f"run {tag}: {sched.flushes} flushes of {flushes}")
        staleness = [s for h in hist if "flush" in h for s in h["staleness"]]
        row = dict(
            engine=tr.proto.engine, transport=tr.proto.transport, codec=tr.resolved_codec,
            k=tr.k, warmup_rounds=tr.proto.warmup_rounds, buffer_size=acfg.buffer_size,
            staleness_mode=acfg.staleness, flushes=sched.flushes, flush_executions=len(lat),
            warmup_s=warm_s, run_s=run_s, flush_ms_p50=float(np.percentile(lat, 50)),
            flush_ms_p99=float(np.percentile(lat, 99)), virtual_time_s=sched.clock.now,
            dispatches=sched.dispatches, max_staleness=max(staleness),
            mean_staleness=float(np.mean(staleness)), giveups=sched.giveups,
            recoveries=[r.to_dict() for r in sched.recoveries],
            edge_crashes=[h.to_dict() for h in hist if h.get("crash") == "edge"],
            eval_ticks=sum(1 for h in hist if "eval" in h), acc_after_warmup=acc_warm,
            acc_end=acc, bytes_by_kind=dict(tr.comm.bytes_by_kind),
            messages_by_kind=dict(tr.comm.messages_by_kind),
            k10_launches=launches["quantize"]["fake_quant"],
            k9_launches=launches["segment_reduce"]["segment_reduce"],
            peak_bytes=(int(torch.cuda.max_memory_allocated()) - base) if on_card else None,
            launches=launches, device=str(device))
        if tr.topology is not None:
            row.update(edges=tr.topology.n_edges, edge_codec=tr.proto.edge_codec,
                       ingress_bytes=dict(tr.ingress_bytes), flat_ingress_bytes=flat_ingress)
        log(f"[run {tag}] {row['engine']}/{row['transport']}/{row['codec']} K={tr.k} on "
            f"{row['device']}: {row['flushes']} flushes ({row['flush_executions']} run, buffer "
            f"{acfg.buffer_size}, {acfg.staleness}) in {run_s:.3f} s, flush p50 "
            f"{row['flush_ms_p50']:.3f} ms p99 {row['flush_ms_p99']:.3f} ms, virtual time "
            f"{row['virtual_time_s']:.4f} s, staleness max {row['max_staleness']} mean "
            f"{row['mean_staleness']:.3f}, give-ups {row['giveups']}, recoveries "
            f"{len(row['recoveries'])}, edge crashes {len(row['edge_crashes'])}, eval ticks "
            f"{row['eval_ticks']}, target acc {acc_warm:.4f} -> {acc:.4f}, bytes "
            f"{row['bytes_by_kind']}, K10 launches {row['k10_launches']}, K9 launches "
            f"{row['k9_launches']}, peak {(row['peak_bytes'] or 0) / 2**20:.1f} MiB above the "
            f"run's start")
        if tr.topology is not None:
            log(f"[run {tag}] E={row['edges']}: server ingress {row['ingress_bytes']} against "
                f"{flat_ingress} with K uplinks")
        return tr, hist, row

    # AD: uniform latencies, no churn, buffer = K: every flush a full buffer at
    # staleness 0, the parameters those of phase 10's H batched run
    uniform = LinkScenario(links=[LinkModel(latency_s=0.25) for _ in range(4)])
    tr_ad, hist_ad, runs["AD"] = async_run(
        "AD", doms5[:4], doms5[4], AsyncConfig(buffer_size=4, staleness="polynomial"),
        flushes=FED_ROUNDS, links=uniform, engine="batched", scenario=full)
    if not all(h["members"] == [0, 1, 2, 3] and h["staleness"] == [0] * 4 for h in hist_ad):
        raise AssertionError("run AD: a flush was not a full buffer at staleness 0")
    ad_err = leaf_err(tr_ad, h_params)
    cross["AD_vs_H_batched_max_leaf_err_over_max1_leaf"] = ad_err
    if not ad_err <= FED_LEAF_TOL:
        raise AssertionError(f"run AD: differs from H batched by {ad_err} of max(1, max|leaf|) "
                             f"> {FED_LEAF_TOL}")
    del tr_ad, hist_ad, h_params
    # AQ: qint8 over heterogeneous links (one slow straggler, losses retried)
    # under Markov churn at an offline fraction of 0.2 (mean on 10 s, off 2.5 s)
    aq_links = LinkScenario(links=[
        LinkModel(latency_s=0.1 * (i + 1), jitter_s=0.05, bandwidth_bps=1e6, drop=0.1)
        for i in range(3)] + [LinkModel(latency_s=8.0, bandwidth_bps=2e4, drop=0.1)])
    aq_avail = markov_trace(4, AQ_HORIZON_S, mean_on=10.0, mean_off=2.5, seed=17)
    aq_cfg = AsyncConfig(buffer_size=AQ_BUFFER, staleness="polynomial", eval_interval=AQ_EVAL_S)
    aq_kw = dict(links=aq_links, availability=aq_avail, engine="batched", **wire_kw)
    _, _, runs["AQ"] = async_run("AQ", doms5[:4], doms5[4], aq_cfg, flushes=AQ_FLUSHES, **aq_kw)
    if runs["AQ"]["k10_launches"] <= 0:
        raise AssertionError("run AQ: K10 was not launched")
    cross["AQ_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("AQ")
    # AC: AQ's setting from one start (a CPU warm-up, checkpointed) on the card
    # and on the CPU: equal histories, parameters within FED_LEAF_TOL.  Omega
    # from the seed-fused stream (K4), as S; AC-mat below runs the same with
    # the materialized Omega
    with tempfile.TemporaryDirectory() as ac_dir:
        tr_ws = FedRFTCATrainer(doms5[:4], doms5[4], fused_cfg, ProtocolConfig(**{
            **fed_kw, "warmup_rounds": AC_WARMUP, "engine": "batched", **wire_kw}), device="cpu")
        tr_ws.save_state(ac_dir, step=0)
        del tr_ws
        ac_kw = dict(aq_kw, cfg=fused_cfg, warmup_rounds=0, start=ac_dir, flushes=AC_FLUSHES)
        tr_acc, hist_acc, runs["AC_card"] = async_run("AC card", doms5[:4], doms5[4], aq_cfg,
                                                      **ac_kw)
        tr_acp, hist_acp, runs["AC_cpu"] = async_run("AC cpu", doms5[:4], doms5[4], aq_cfg,
                                                     device="cpu", **ac_kw)
        # the same start and events over an identity float32 wire: no bin to
        # flip, so the strict gate alone
        f32_kw = dict(ac_kw, transport="identity", codec="float32")
        tr_fc, hist_fc, runs["AC_f32_card"] = async_run("AC f32 card", doms5[:4], doms5[4],
                                                        aq_cfg, **f32_kw)
        tr_fp, hist_fp, runs["AC_f32_cpu"] = async_run("AC f32 cpu", doms5[:4], doms5[4],
                                                       aq_cfg, device="cpu", **f32_kw)
    ac_f32_err = leaf_err(tr_fc, params_of(tr_fp))
    cross["AC_f32_card_vs_cpu_max_leaf_err_over_max1_leaf"] = ac_f32_err
    if history_rows(hist_fc) != history_rows(hist_fp) or not ac_f32_err <= FED_LEAF_TOL:
        raise AssertionError(f"run AC f32: card and CPU differ by {ac_f32_err} of max(1, "
                             f"max|leaf|), or their histories differ")
    del tr_fc, tr_fp, hist_fc, hist_fp
    if history_rows(hist_acc) != history_rows(hist_acp):
        raise AssertionError("run AC: the card's and the CPU's histories differ")
    ac_err = leaf_err(tr_acc, params_of(tr_acp))
    # a qint8 bin can flip where the card's and the CPU's payloads part by one
    # rounding (tests/test_torch_federated.py's qint8 parity rule): then every
    # entry must be within one quantization step of its leaf and 99 % within
    # FED_LEAF_TOL of max(1, max|leaf|)
    within, total, step_ok = 0, 0, True
    for a, b in zip(params_of(tr_acc), params_of(tr_acp)):
        d = (a.cpu() - b).abs()
        within += int((d <= FED_LEAF_TOL * max(1.0, float(b.abs().max()))).sum())
        total += d.numel()
        step_ok &= float(d.max()) <= max(float(b.abs().max()) / 127, FED_LEAF_TOL)
    cross["AC_card_vs_cpu_max_leaf_err_over_max1_leaf"] = ac_err
    cross["AC_card_vs_cpu_share_within_tol"] = within / total
    cross["AC_history_rows_equal"] = True
    if not (ac_err <= FED_LEAF_TOL or (step_ok and within >= 0.99 * total)):
        raise AssertionError(f"run AC: card and CPU differ by {ac_err} of max(1, max|leaf|), "
                             f"{within} of {total} entries within {FED_LEAF_TOL}")
    cross["AC_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("AC card")
    del tr_acc, tr_acp, hist_acc, hist_acp
    # AC-mat: AC again with the default materialized Omega (draw_omega), which
    # one seed draws the same on the card and the CPU; AC's gates
    with tempfile.TemporaryDirectory() as ac_dir:
        tr_ws = FedRFTCATrainer(doms5[:4], doms5[4], fed_cfg, ProtocolConfig(**{
            **fed_kw, "warmup_rounds": AC_WARMUP, "engine": "batched", **wire_kw}), device="cpu")
        tr_ws.save_state(ac_dir, step=0)
        del tr_ws
        mat_kw = dict(aq_kw, cfg=fed_cfg, warmup_rounds=0, start=ac_dir, flushes=AC_FLUSHES)
        tr_mc, hist_mc, runs["AC_mat_card"] = async_run("AC-mat card", doms5[:4], doms5[4],
                                                        aq_cfg, **mat_kw)
        tr_mp, hist_mp, runs["AC_mat_cpu"] = async_run("AC-mat cpu", doms5[:4], doms5[4],
                                                       aq_cfg, device="cpu", **mat_kw)
    if not torch.equal(tr_mc.omega.cpu(), tr_mp.omega):
        raise AssertionError("run AC-mat: the card's and the CPU's Omega differ")
    if history_rows(hist_mc) != history_rows(hist_mp):
        raise AssertionError("run AC-mat: the card's and the CPU's histories differ")
    mat_err = leaf_err(tr_mc, params_of(tr_mp))
    within, total, step_ok = 0, 0, True
    for a, b in zip(params_of(tr_mc), params_of(tr_mp)):
        d = (a.cpu() - b).abs()
        within += int((d <= FED_LEAF_TOL * max(1.0, float(b.abs().max()))).sum())
        total += d.numel()
        step_ok &= float(d.max()) <= max(float(b.abs().max()) / 127, FED_LEAF_TOL)
    cross["AC_mat_card_vs_cpu_max_leaf_err_over_max1_leaf"] = mat_err
    cross["AC_mat_card_vs_cpu_share_within_tol"] = within / total
    if not (mat_err <= FED_LEAF_TOL or (step_ok and within >= 0.99 * total)):
        raise AssertionError(f"run AC-mat: card and CPU differ by {mat_err} of max(1, "
                             f"max|leaf|), {within} of {total} entries within {FED_LEAF_TOL}")
    cross["AC_mat_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("AC-mat card")
    del tr_mc, tr_mp, hist_mc, hist_mp
    # AL: FL's fleet asynchronous, one buffer of 16 per edge, merged edge
    # uplinks over a backhaul, an edge crash and a server crash restored from
    # the last checkpoint
    al_links = LinkScenario(links=[LinkModel(latency_s=0.2 + 0.01 * (i % 37), jitter_s=0.1)
                                   for i in range(FL_K)])
    al_edges = LinkScenario(links=[LinkModel(latency_s=0.3 + 0.01 * e, jitter_s=0.05)
                                   for e in range(FL_EDGES)])
    with tempfile.TemporaryDirectory() as al_dir:
        al_cfg = AsyncConfig(buffer_size=AL_BUFFER, staleness="polynomial",
                             server_crash_times=(AL_CRASH_S,), checkpoint_interval_s=AL_CKPT_S,
                             edge_crash_times=(AL_EDGE_CRASH,), restart_delay_s=0.5,
                             ckpt_dir=al_dir)
        tr_al, _, runs["AL"] = async_run(
            "AL", doms_fl[:FL_K], doms_fl[FL_K], al_cfg, flushes=AL_FLUSHES, links=al_links,
            edge_links=al_edges, engine="batched", warmup_rounds=FL_WARMUP,
            topology=Topology.uniform(FL_K, FL_EDGES), client_chunk=FL_CHUNK,
            edge_codec="qint8", **wire_kw)
    al = runs["AL"]
    if al["k9_launches"] <= 0 or al["k10_launches"] <= 0:
        raise AssertionError(f"run AL: K9 {al['k9_launches']}, K10 {al['k10_launches']} launches")
    if len(al["recoveries"]) != 1 or len(al["edge_crashes"]) != 1:
        raise AssertionError(f"run AL: {al['recoveries']} recoveries, {al['edge_crashes']}")
    if not sum(al["ingress_bytes"].values()) < sum(al["flat_ingress_bytes"].values()):
        raise AssertionError(f"run AL: ingress {al['ingress_bytes']} not below the flat "
                             f"{al['flat_ingress_bytes']}")
    cross["AL_k10_launch_shapes_bit_for_bit"] = check_main_path_k10("AL")
    cross["AL_k9_launch_shapes"] = check_main_path_k9("AL")
    del tr_al, doms_fl
    quantize.fake_quant = k10_launch
    seg_k.segment_reduce = k9_launch
    torch.cuda.synchronize()
    runs["AL"]["phase_13_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 13 (AD, AQ, AC, AL) {runs['AL']['phase_13_s']:.1f} s")
    log(f"[cross] AD vs H batched {ad_err:.3g}, AC card vs CPU {ac_err:.3g} ("
        f"{cross['AC_card_vs_cpu_share_within_tol']:.6f} of entries within {FED_LEAF_TOL}), "
        f"AC over float32 {ac_f32_err:.3g}, AC-mat {mat_err:.3g} ("
        f"{cross['AC_mat_card_vs_cpu_share_within_tol']:.6f} within)")

    # ---- 14. the aligner server (serve) and the telemetry (obs) -------------
    serve_runs, serve_cross = serve_phase(torch, dev, doms, counters, dict(
        fed_kw=fed_kw, full=full, fed_cfg=fed_cfg, doms5=doms5, params_of=params_of,
        FedRFTCATrainer=FedRFTCATrainer, ProtocolConfig=ProtocolConfig))
    runs.update(serve_runs)
    cross.update(serve_cross)

    # ---- 15. training: K11b, then T, TC and BL --------------------------------
    t_phase = time.perf_counter()
    report["K11b"], k11_fwd = k11b_rows(
        torch, dev, [(*shape, 1.0) for shape in K11_CHECK]
        + [(*shape, "bfloat16", True, 0, K11_V_SCALE) for shape in K11_LARGE_V], K11B_TIMED)
    report["K11"]["forward_with_lse"] = {str(k): v for k, v in k11_fwd.items()}
    train_runs, train_launches = train_phase(torch, dev, doms, counters)
    runs.update(train_runs)
    report["K11b"]["launches"] = train_launches["T"]["flash_attention_bwd"]
    report["K11b"]["launches_by_run"] = {t: n["flash_attention_bwd"]
                                         for t, n in train_launches.items()}
    report["K11"]["launches_by_run"].update(
        {t: n["flash_attention"] for t, n in train_launches.items()})
    torch.cuda.synchronize()
    log(f"[time] phase 15 (K11b, T, TC, BL) {time.perf_counter() - t_phase:.1f} s")

    # ---- 16. the MoE family: Q, DS, QC, DC, QH, DH, DP --------------------------
    t_phase = time.perf_counter()
    moe_runs, moe_launches = moe_phase(torch, dev, k11_check_model)
    runs.update(moe_runs)
    report["K11"]["launches_by_run"].update(moe_launches)
    torch.cuda.synchronize()
    runs["DP"]["phase_16_s"] = time.perf_counter() - t_phase
    log(f"[time] phase 16 (Q, DS, QC, DC, QH, DH, DP) {runs['DP']['phase_16_s']:.1f} s")

    la = {t: runs[t]["launches"] for t in ("A", "B", "C", "D", "E")}
    served = {t: serve_runs[t]["launches"] for t in serve_runs if t != "HP"}
    for key, runs_of, count in (
            ("K4", {**la, **served}, lambda c: c["prng"]["fused_omega"]),
            ("K1", {**la, **served}, lambda c: c["rff"]["rff"]),
            ("K5", {"A": la["A"], **served}, lambda c: sum(c["gram"].values()))):
        report[key]["launches_by_run"] = {t: count(c) for t, c in runs_of.items() if count(c)}
        report[key]["launches"] = sum(report[key]["launches_by_run"].values())
    report["K7"]["launches"] = sum(la[t]["rff"]["rff_fused"] for t in la)
    report["K5"]["parts"] = la["A"]["gram"]
    for key, tag, group in (("K6", "B", "gram"), ("K2", "C", "operand_gram"),
                            ("K3", "D", "operand_gram")):
        report[key]["launches"] = sum(la[tag][group].values())
        report[key]["parts"] = la[tag][group]
    report["K8"]["launches"] = la["E"]["centered_gram"]["centered_gram"]
    trained = [t for t in runs if "k10_launches" in runs[t]]
    for key, field in (("K10", "k10_launches"), ("K9", "k9_launches")):
        report[key]["launches_by_run"] = {t: runs[t][field] for t in trained if runs[t][field]}
        report[key]["launches"] = sum(report[key]["launches_by_run"].values())
    kernels = [dict(id=k, **report[k]) for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7",
                                                 "K8", "K9", "K10", "K11", "K11b")]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['id']} was not launched on the main path")
    print(json.dumps({"runs": runs, "cross": cross}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
