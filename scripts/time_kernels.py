#!/usr/bin/env python3
"""Time one family of the port's tensor-core kernels on one CUDA card, at
``chip_smoke.py``'s data, through the public entry points.

The data is ``chip_smoke.py``'s (``make_domains(seed=0)``, p = 2048, n =
3612, sigma by the median heuristic).  Families:

  seed_fused  the seed-fused featurize (K7, N = 4096) and streamed Gram (K5,
              N = 1000, S = 1) with Gaussian and Cauchy (``laplace``) draws,
              and K6 (N = 4096, S = 4) with Gaussian draws.  With Cauchy
              draws the featurize recomputes the phases in float64.
  operand     the operand-Omega streamed Gram (K2 at N = 1000, one chunk; K3
              at N = 4096, two chunks; Omega from ``draw_omega``, and K2 also
              with a Cauchy Omega) and the centered Gram (K8 at 2N = 2000 and
              8192 on K1's Sigma), each beside one library call: ``torch.matmul``
              of the same products (Omega X and [cos; sin] [cos; sin]^T; the
              centered Sigma times its transpose).
  k1          the operand-Omega featurize (K1, Omega from ``fused_omega``)
              at N = 1000 and 4096 on all 3612 columns and on a transform
              request's 64, 300 and 512 (the first target columns), and at
              N = 1000 on all columns with a Cauchy Omega (``draw_omega``'s
              laplace), each beside ``torch.matmul(Omega, X)``.
  all         seed_fused, operand and k1 on one copy of the data.
  cauchy      the featurize's recompute: K1 with a Cauchy Omega
              (``draw_omega``'s laplace) at N = 1000 on 64, 300, 512 and all
              3612 columns and at N = 4096 on 300 and 3612, K7 with Cauchy
              draws (N = 4096) on 300 and 3612, K5 (N = 1000, S = 1) and K2
              (N = 1000) with Cauchy draws or Omega; beside them the same
              paths with Gaussian Omega (K1 at 3612 columns, K7, K5, K6 at N
              = 4096, S = 4, K2), which recompute nothing.  Each path's
              counters (``counters=``: Omega drawn, phases recomputed, Omega
              the recompute drew) and a digest of its outputs (the first 16
              hex digits of their bytes' SHA-256), to hold two checkouts'
              outputs bit for bit.
  edge        the reference's element rule on the Cauchy featurize
              (``chip_smoke.py``'s ``featurize_rule``: within 2e-5 of plain,
              or, where plain is past 2e-5 from the float64 answer, no
              farther from it): K1 (``draw_omega``'s laplace, N = 1000) on
              64, 300, 512 and 3612 columns and K7 (N = 4096, draws 0 and 1)
              on 300 and 3612.  For the kernel's output and for the float64
              answer rounded to nearest fp32: the elements past 2e-5 of plain
              where plain is within 2e-5 of the float64 answer, and those
              where both are past and the output is farther; and the
              kernel's largest distance from the float64 answer.
  split       the Grams whose k is split across blocks (K2 and K5 at N =
              1000, K8 at 2N = 2000) under ``torch.profiler``
              (``device_profile.profile_calls``): each call's device time
              by kernel, the split's sum (``gram_split_reduce_kernel``,
              where the checkout has one) apart from the products.
  bf16        the bf16 dense statistics: K1-bf16 (N = 4096 on all 3612
              columns, bf16 X and Omega from ``fused_omega``) and K8-bf16 on
              its Sigma (2N = 8192) and on the first 1000 rows of Omega's
              (2N = 2000), each beside bf16 ``torch.matmul`` (Omega X; Sigma
              Sigma^T); the fp32 K8 (2N = 2000, 8192), K2 and K5 (N = 1000)
              beside them; a digest of the SASS of each fp32 Gram kernel
              (``gram_tf32_kernel``, in ``centered_gram`` and
              ``rff_gram_stream_fused``, its name left out); and the launch
              floor: an empty kernel (``torch.cuda._sleep(0)``) beside K9 at
              (1024, 1025) into 64 edges and K10 at (5, 1024), as
              ``chip_smoke.py`` times those two (``timed``, the inputs cycled
              past the L2).
  fleet       the fleet's two kernels as the path calls them, beside the
              kernels alone and an empty launch: K9 through
              ``hierarchy._sums_and_mass`` (the sums and the masses of FL's
              W_RF and moment merges, (1024, 32768) and (1024, 1024) into 64
              edges, with the engine's plan where the checkout has one) and
              the kernel alone (a checkout without the masses in the
              kernel: the kernel on the payload with its ones column), and
              K10 through
              ``QuantCodec(8).roundtrip`` at (65, 32768) and (5, 1024), with
              uniforms and without, and the kernel alone (with its scale
              computed in it, or given); each function's device operations
              counted by ``torch.profiler``; no domains are made.
  fl          FL alone, end to end (``chip_smoke.py`` phase 10's fleet run:
              1024 sources over 64 edges, qint8 on both tiers, batched,
              client chunk 128): the trainer's set-up and warm-up, the
              wall-clock of ``train()``, each round's p50 and p99 (synchronised
              after each round), and the accuracy at the end; the kernels are
              built before the clock starts.
  k11b        K11's backward (``flash_attention_backward``, bf16, causal) at
              ``chip_smoke.py``'s two training shapes (``K11B_TIMED``),
              (8, 9, 3, 2048, 64) and (1, 16, 8, 4096, 128), beside the plain backward and
              ``scaled_dot_product_attention``'s backward (one PyTorch call:
              ``torch.autograd.grad`` through it); no domains are made.

It uses only the public entry points of the package under the working
directory's ``src/`` and takes its data, shapes and timing from the
``chip_smoke.py`` beside this script, so it runs against any checkout of the
port: run it from the root of two checkouts in one call to compare them on
one card.

    python3 scripts/time_kernels.py seed_fused
    python3 scripts/time_kernels.py operand
    python3 scripts/time_kernels.py k1
    python3 scripts/time_kernels.py all
    python3 scripts/time_kernels.py cauchy
    python3 scripts/time_kernels.py edge
    python3 scripts/time_kernels.py split
    python3 scripts/time_kernels.py bf16
    python3 scripts/time_kernels.py k11b
    python3 scripts/time_kernels.py fleet
    python3 scripts/time_kernels.py fl

Prints one JSON object: milliseconds per call (CUDA events, after a warm-up
call; ``k11b`` with ``chip_smoke.py``'s ``k11b_times``, cycling copies of
the inputs past the L2) for each kernel and library call, and the card's
name.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path.cwd()
# the package from the working directory's checkout; the data, shapes and
# timing (chip_smoke.py) from this script's, so two checkouts are timed alike
sys.path[:0] = [str(ROOT / "src"), str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parent)]


def seed_fused(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.kernels import rff
    from repro_torch.kernels import rff_gram_stream as gram

    for kind in ("gauss", "laplace"):
        kw = dict(n_features=4096, seed=cs.SEED, ensemble_index=1, sigma=sigma, rf_kernel=kind)
        out[f"K7_{kind}_ms"] = cs.cuda_ms(torch, lambda: rff.rff_fused(x, **kw), 5)
        kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma, rf_kernel=kind)
        out[f"K5_{kind}_ms"] = cs.cuda_ms(
            torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 3)
    kw = dict(n_features=4096, seed=cs.SEED, ensemble=4, sigma=sigma)
    out["K6_gauss_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 3)


def operand(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import rff
    from repro_torch.kernels import centered_gram as centered
    from repro_torch.kernels import rff_gram_stream as gram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = x.device
    for key, nf in (("K2", 1000), ("K3", 4096)):
        om = draw_omega(cs.SEED, nf, cs.P, sigma=sigma, device=dev)
        out[f"{key}_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 5)
        z = om @ x
        w = torch.cat([torch.cos(z), torch.sin(z)])
        out[f"{key}_library_ms"] = cs.cuda_ms(
            torch, lambda: (torch.matmul(om, x), torch.matmul(w, w.T)), 5)
        del z, w
        sig = rff.rff(x, om)
        c = sig - sig.mean(dim=1, keepdim=True)
        out[f"K8_{2 * nf}_ms"] = cs.cuda_ms(torch, lambda: centered.centered_gram(sig), 5)
        out[f"K8_{2 * nf}_library_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(c, c.T), 5)
        del sig, c, om
    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, kernel="laplace", device=dev)
    out["K2_laplace_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 5)


def k1(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import prng, rff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = x.device
    xt = x[:, cs.N_S:]
    for nf in (1000, 4096):
        om = prng.fused_omega(cs.SEED, nf, cs.P, sigma=sigma, device=dev)
        for w in (x.shape[1], 64, 300, 512):
            xk = x if w == x.shape[1] else xt[:, :w].contiguous()
            out[f"K1_{nf}_{w}_ms"] = cs.cuda_ms(torch, lambda: rff.rff(xk, om), 20)
            out[f"K1_{nf}_{w}_library_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(om, xk), 20)
    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, kernel="laplace", device=dev)
    out["K1_laplace_ms"] = cs.cuda_ms(torch, lambda: rff.rff(x, om), 10)


def cauchy(cs, torch, x, ell, sigma, out) -> None:
    import hashlib

    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import rff
    from repro_torch.kernels import rff_gram_stream as gram

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev, full = x.device, x.shape[1]
    xt = x[:, cs.N_S:]

    def record(key, fn, reps):
        cnt = torch.zeros(3, dtype=torch.int64, device=dev)
        res = fn(cnt)
        h = hashlib.sha256()
        for t in res if isinstance(res, tuple) else (res,):
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[f"{key}_counters"] = cnt.tolist()
        out[f"{key}_digest"] = h.hexdigest()[:16]
        out[f"{key}_ms"] = cs.cuda_ms(torch, lambda: fn(None), reps)

    for kind in ("laplace", "gauss"):
        widths = {1000: (64, 300, 512, full), 4096: (300, full)} if kind == "laplace" else {
            1000: (full,), 4096: (full,)}
        for nf, ws in widths.items():
            om = draw_omega(cs.SEED, nf, cs.P, sigma=sigma, kernel=kind, device=dev)
            for w in ws:
                xk = x if w == full else xt[:, :w].contiguous()
                record(f"K1_{kind}_{nf}_{w}",
                       lambda c, xk=xk, om=om: rff.rff(xk, om, counters=c), 10)
            if nf == 1000:
                record(f"K2_{kind}", lambda c, om=om: gram.rff_gram_stream(x, om, ell, counters=c),
                       5)
            del om
        for w in ((300, full) if kind == "laplace" else (full,)):
            xk = x if w == full else xt[:, :w].contiguous()
            kw = dict(n_features=4096, seed=cs.SEED, ensemble_index=1, sigma=sigma,
                      rf_kernel=kind)
            record(f"K7_{kind}_{w}", lambda c, xk=xk, kw=kw: rff.rff_fused(xk, counters=c, **kw),
                   5)
        kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma, rf_kernel=kind)
        record(f"K5_{kind}", lambda c: gram.rff_gram_stream_fused(x, ell, counters=c, **kw), 3)
    kw = dict(n_features=4096, seed=cs.SEED, ensemble=4, sigma=sigma)
    record("K6_gauss", lambda c: gram.rff_gram_stream_fused(x, ell, counters=c, **kw), 3)


def edge(cs, torch, x, ell, sigma, out) -> None:
    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import prng, rff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev, full = x.device, x.shape[1]
    xt = x[:, cs.N_S:]

    def outside(k, plain, exact):
        within = (k - plain).abs() <= 2e-5
        d_k, d_p = (k.double() - exact).abs(), (plain.double() - exact).abs()
        off = d_p > 2e-5
        return [int((~within & ~off).sum()), int((~within & off & (d_k > d_p)).sum())]

    def rule(key, om, xk, k, plain):
        z = om.double() @ xk.double()
        exact = torch.cat([torch.cos(z), torch.sin(z)]) * rff.inv_sqrt(om.shape[0])
        del z
        out[f"{key}_kernel_outside"] = outside(k, plain, exact)
        out[f"{key}_nearest_outside"] = outside(exact.float(), plain, exact)
        out[f"{key}_kernel_vs_exact"] = float((k.double() - exact).abs().max())

    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, kernel="laplace", device=dev)
    for w in (64, 300, 512, full):
        xk = x if w == full else xt[:, :w].contiguous()
        rule(f"K1_laplace_1000_{w}", om, xk, rff.rff(xk, om), rff.rff_plain(xk, om))
    del om
    for e in (0, 1):
        kw = dict(n_features=4096, seed=cs.SEED, ensemble_index=e, sigma=sigma,
                  rf_kernel="laplace")
        om = prng.fused_omega_block_plain(cs.SEED, 4096, cs.P, ensemble_index=e, sigma=sigma,
                                          rf_kernel="laplace", device=dev)
        for w in (300, full):
            xk = x if w == full else xt[:, :w].contiguous()
            rule(f"K7_laplace_e{e}_{w}", om, xk, rff.rff_fused(xk, **kw),
                 rff.rff_fused_plain(xk, **kw))
        del om


def split(cs, torch, x, ell, sigma, out) -> None:
    from device_profile import profile_calls

    from repro_torch.core.rff import draw_omega
    from repro_torch.kernels import rff
    from repro_torch.kernels import centered_gram as centered
    from repro_torch.kernels import rff_gram_stream as gram

    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, device=x.device)
    sig = rff.rff(x, om)
    kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma)
    for key, fn in (("K2", lambda: gram.rff_gram_stream(x, om, ell)),
                    ("K5", lambda: gram.rff_gram_stream_fused(x, ell, **kw)),
                    ("K8_2000", lambda: centered.centered_gram(sig))):
        fn()
        out[f"{key}_kernels_ms"] = profile_calls(fn, 5, 8)["top_kernels_ms_per_call"]


def sass_digest(cs, lib: str, name: str) -> dict:
    """sha256 of each SASS function of ``lib`` whose mangled name contains
    ``name``, over its instructions alone (``chip_smoke.sass_functions``)."""
    import hashlib

    from repro_torch.kernels import _build

    return {fn: hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
            for fn, body in cs.sass_functions(_build.sass(lib)).items() if name in fn}


def bf16(cs, torch, x, ell, sigma, out) -> None:
    import itertools

    from repro_torch.core.rff import draw_omega
    from repro_torch.fleet import Topology
    from repro_torch.kernels import centered_gram as centered
    from repro_torch.kernels import prng, quantize, rff
    from repro_torch.kernels import rff_gram_stream as gram
    from repro_torch.kernels import segment_reduce as seg_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = x.device
    om16 = prng.fused_omega(cs.SEED, 4096, cs.P, sigma=sigma, device=dev).bfloat16()
    x16 = x.bfloat16()
    out["K1_bf16_ms"] = cs.cuda_ms(torch, lambda: rff.rff(x16, om16), 20)
    out["K1_bf16_library_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(om16, x16), 20)
    for rows, om in ((8192, om16), (2000, om16[:1000].contiguous())):
        s16 = rff.rff(x16, om)
        out[f"K8_bf16_{rows}_ms"] = cs.cuda_ms(torch, lambda: centered.centered_gram(s16), 5)
        out[f"K8_bf16_{rows}_library_ms"] = cs.cuda_ms(torch, lambda: torch.matmul(s16, s16.T), 5)
    del om16, x16, s16
    for nf in (1000, 4096):
        sig = rff.rff(x, draw_omega(cs.SEED, nf, cs.P, sigma=sigma, device=dev))
        out[f"K8_{2 * nf}_ms"] = cs.cuda_ms(torch, lambda: centered.centered_gram(sig), 5)
        del sig
    om = draw_omega(cs.SEED, 1000, cs.P, sigma=sigma, device=dev)
    out["K2_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream(x, om, ell), 5)
    kw = dict(n_features=1000, seed=cs.SEED, ensemble=1, sigma=sigma)
    out["K5_ms"] = cs.cuda_ms(torch, lambda: gram.rff_gram_stream_fused(x, ell, **kw), 5)
    out["sass_gram_tf32"] = {lib: sass_digest(cs, lib, "gram_tf32_kernel")
                             for lib in ("centered_gram", "rff_gram_stream_fused")}
    # the launch floor beside K9's and K10's small shapes
    out["empty_launch_ms"] = cs.timed(torch, lambda: torch.cuda._sleep(0), 200)["ms"]
    k, d, e = 1024, 1025, 64
    seg = torch.as_tensor(Topology.uniform(k, e).segment_ids, device=dev)
    g = torch.Generator(device=dev).manual_seed(k + d)
    copies = [(torch.randn((k, d), generator=g, device=dev), seg,
               (torch.rand((k,), generator=g, device=dev) < 0.8).float())
              for _ in range(max(2, -(-cs.L2_FLUSH_BYTES // ((k * d + 2 * k + e * d) * 4))))]
    turn = itertools.cycle(copies)
    out["K9_1024_1025_ms"] = cs.timed(torch, lambda: seg_k.segment_reduce(*next(turn), e), 50)["ms"]
    rows, d = 5, 1024
    copies = []
    for _ in range(max(1, -(-cs.L2_FLUSH_BYTES // (12 * rows * d + 4 * rows)))):
        xq = torch.randn((rows, d), generator=g, device=dev)
        copies.append((xq, torch.rand((rows, d), generator=g, device=dev),
                       quantize.quant_scale(xq, 127)))
    turn = itertools.cycle(copies)
    out["K10_5_1024_ms"] = cs.timed(torch, lambda: quantize.fake_quant(*next(turn), qmax=127),
                                    200)["ms"]


def fleet(cs, torch, out) -> None:
    import itertools

    from repro_torch.comm.codecs import QuantCodec
    from repro_torch.fleet import Topology, hierarchy
    from repro_torch.kernels import quantize
    from repro_torch.kernels import segment_reduce as seg_k

    dev = torch.device("cuda")
    planned = hasattr(seg_k, "membership_plan")  # this checkout's kernel writes the masses
    out["empty_launch_ms"] = cs.timed(torch, lambda: torch.cuda._sleep(0), 200)["ms"]
    for k, d, e in cs.K9_TIMED:
        seg = torch.as_tensor(Topology.uniform(k, e).segment_ids, device=dev)
        plan = seg_k.membership_plan(seg.cpu().numpy(), e, dev) if planned else None
        g = torch.Generator(device=dev).manual_seed(k + d)
        copies = [(torch.randn((k, d), generator=g, device=dev),
                   (torch.rand((k,), generator=g, device=dev) < 0.8).float())
                  for _ in range(max(2, -(-cs.L2_FLUSH_BYTES // (4 * k * d))))]
        turn = itertools.cycle(copies)
        key = f"K9_{k}_{d}_{e}"
        members = plan if planned else seg
        merge = lambda: hierarchy._sums_and_mass(*next(turn), members, e)
        t = cs.timed(torch, merge, 50)
        out[f"{key}_function_ms"], out[f"{key}_function_queued"] = t["ms"], t["queued"]
        out[f"{key}_function_device_ops"] = len(cs.device_ops(torch, merge))
        if planned:
            def kernel():
                v, w = next(turn)
                return seg_k.segment_reduce(v, plan, w, e, with_mass=True)
        else:  # the kernel on the payload with the ones column the merge appends
            copies = [(torch.cat([v, torch.ones((k, 1), device=dev)], 1), w) for v, w in copies]
            turn = itertools.cycle(copies)

            def kernel():
                v, w = next(turn)
                return seg_k.segment_reduce(v, seg, w, e)

        out[f"{key}_kernel_ms"] = cs.timed(torch, kernel, 50)["ms"]
        del copies, turn
    fused = hasattr(quantize, "fake_quant_fused")  # this checkout's kernel computes the scale
    for rows, d in cs.K10_TIMED:
        g = torch.Generator(device=dev).manual_seed(rows + d)
        copies = []
        for _ in range(max(1, -(-cs.L2_FLUSH_BYTES // (12 * rows * d)))):
            x = torch.randn((rows, d), generator=g, device=dev)
            copies.append((x, torch.rand((rows, d), generator=g, device=dev),
                           quantize.quant_scale(x, 127)))
        turn = itertools.cycle(copies)
        codec = QuantCodec(8)
        key = f"K10_{rows}_{d}"
        for tag, trip in (("", lambda: codec.roundtrip(*next(turn)[:2])),
                          ("_no_u", lambda: codec.roundtrip(next(turn)[0]))):
            t = cs.timed(torch, trip, 50)  # 50: the parent's 7-8 operations a call fit the queue
            out[f"{key}_function{tag}_ms"] = t["ms"]
            out[f"{key}_function{tag}_queued"] = t["queued"]
            out[f"{key}_function{tag}_device_ops"] = len(cs.device_ops(torch, trip))
        if fused:
            out[f"{key}_kernel_ms"] = cs.timed(
                torch, lambda: quantize.fake_quant_fused(*next(turn)[:2], qmax=127), 200)["ms"]
        out[f"{key}_given_scale_kernel_ms"] = cs.timed(
            torch, lambda: quantize.fake_quant(*next(turn), qmax=127), 200)["ms"]
        del copies, turn


def fl(cs, torch, out) -> None:
    import time

    import numpy as np

    from repro_torch.configs import fedrf_paper
    from repro_torch.data import make_domains
    from repro_torch.federated import FedRFTCATrainer, ProtocolConfig
    from repro_torch.fleet import Topology

    doms = make_domains(cs.FL_K + 1, 400, shift=1.2, seed=3)
    cfg = ProtocolConfig(
        n_rounds=cs.FL_ROUNDS, t_c=fedrf_paper.PROTOCOL.t_c, warmup_rounds=cs.FL_WARMUP,
        lr=fedrf_paper.PROTOCOL.lr, drop_setting="III", seed=cs.SEED, engine="batched",
        topology=Topology.uniform(cs.FL_K, cs.FL_EDGES), client_chunk=cs.FL_CHUNK,
        transport="wire", codec="qint8", edge_codec="qint8")
    t0 = time.perf_counter()
    tr = FedRFTCATrainer(doms[:cs.FL_K], doms[cs.FL_K], fedrf_paper.CLIENT, cfg,
                         device=torch.device("cuda"))
    torch.cuda.synchronize()
    out["FL_warmup_s"] = time.perf_counter() - t0
    lat = []
    step = tr.round

    def timed_round(t):
        t1 = time.perf_counter()
        res = step(t)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
        return res

    tr.round = timed_round
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    out["FL_train_s"] = time.perf_counter() - t0
    out["FL_rounds"] = len(lat)
    out["FL_round_ms_p50"] = float(np.percentile(lat, 50))
    out["FL_round_ms_p99"] = float(np.percentile(lat, 99))
    out["FL_acc_end"] = tr.evaluate()


def k11b(cs, torch, out) -> None:
    from repro_torch.kernels import flash_attention as fa

    for shape in cs.K11B_TIMED:
        key = "K11b_" + "_".join(map(str, shape[:5]))
        t = cs.k11b_times(torch, fa, cs.k11b_copies(torch, fa, shape))
        out.update({f"{key}_ms": t["ms"], f"{key}_library_ms": t["library_ms"],
                    f"{key}_plain_ms": t["plain_ms"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("family", choices=("seed_fused", "operand", "k1", "all", "cauchy", "edge",
                                       "split", "bf16", "k11b", "fleet", "fl"))
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.kernels_math import ell_vector, median_sigma
    from repro_torch.data import make_domains
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.build_all()
    out = {"device": torch.cuda.get_device_name(0), "root": str(ROOT), "family": args.family}
    if args.family in ("k11b", "fleet", "fl"):
        {"k11b": k11b, "fleet": fleet, "fl": fl}[args.family](cs, torch, out)
        print(json.dumps(out))
        return 0
    doms = make_domains(2, cs.N_S, dim=cs.P, seed=cs.SEED)
    x = torch.tensor(np.ascontiguousarray(np.concatenate([doms[0].x, doms[1].x[:, :cs.N_T]], 1)),
                     device=dev)
    ell = ell_vector(cs.N_S, cs.N_T, device=dev)
    sigma = median_sigma(x)
    families = {"seed_fused": seed_fused, "operand": operand, "k1": k1, "cauchy": cauchy,
                "edge": edge, "split": split, "bf16": bf16}
    for name in ("seed_fused", "operand", "k1") if args.family == "all" else (args.family,):
        families[name](cs, torch, x, ell, sigma, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
