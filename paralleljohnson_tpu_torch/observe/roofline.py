"""Roofline attribution: is a solve bandwidth-bound, compute-bound, or
host-IO-bound?

Combines the analytic bytes and operations of the solve's kernels
(``observe.costs``) with its measured phase and pipeline times
(``SolverStats``) and a per-platform peak table. The bound kinds are the
JAX package's strings, so records from both packages read alike:
``"hbm"`` is the device memory, and ``"mxu"`` (the TPU's matrix unit
there) stands for the FP32 pipes on ``cuda``.
"""

from __future__ import annotations

# Per-platform peaks: memory bandwidth (GB/s) and f32 compute (GFLOP/s).
# cuda: NVIDIA H100 SXM5 80GB at 700 W, datasheet figures (HBM3
# 3.35 TB/s; 67 TFLOP/s FP32 outside the tensor cores, an FMA counted as
# two operations). A card set below 700 W runs slower under load, so
# the cuda records carry the card's name and power limit beside these.
# cpu: order of magnitude of one container core. Platforms not listed
# fall back to the cpu row.
PLATFORM_PEAKS: dict[str, dict] = {
    "cuda": {"mem_gbps": 3350.0, "flops_gflops": 67000.0},
    "cpu": {"mem_gbps": 20.0, "flops_gflops": 100.0},
}
# f64 compute (GFLOP/s) where it differs from the f32 row: the H100 SXM5's
# 34 TFLOP/s FP64 outside the tensor cores (datasheet, an FMA counted as
# two operations), half its FP32 rate. A precision="f64" solve is
# classified against it.
F64_PEAK_GFLOPS: dict[str, float] = {"cuda": 34000.0}

# A solve whose host-side IO (downloads + pipeline waits, net of what
# the overlap hid) exceeds this fraction of the wall is host-IO-bound
# regardless of what the kernels' analytic costs say.
HOST_IO_DOMINANCE = 0.5

BOUND_KINDS = ("hbm", "mxu", "host-io", "unknown")


def peaks_for(platform: str, precision: str = "f32") -> dict:
    """``{"mem_gbps", "flops_gflops"}`` of ``platform`` for distances of
    ``precision`` ("f32" or "f64"): at f64 the compute peak is
    ``F64_PEAK_GFLOPS``'s where it lists the platform."""
    row = PLATFORM_PEAKS.get(platform, PLATFORM_PEAKS["cpu"])
    if precision == "f64" and platform in F64_PEAK_GFLOPS:
        return {**row, "flops_gflops": F64_PEAK_GFLOPS[platform]}
    return row


def classify(
    *,
    flops: float | None = None,
    bytes_accessed: float | None = None,
    compute_s: float | None = None,
    host_io_s: float = 0.0,
    wall_s: float | None = None,
    platform: str = "cpu",
    precision: str = "f32",
) -> dict:
    """One roofline classification.

    Returns ``{"bound": "hbm"|"mxu"|"host-io"|"unknown", ...}`` with the
    derived times (``t_hbm_s``, ``t_mxu_s``), the arithmetic intensity
    against the platform's ridge point, the roofline floor, and a
    one-line ``why``. ``precision`` picks the compute peak
    (:func:`peaks_for`)."""
    peaks = peaks_for(platform, precision)
    out: dict = {"platform": platform, "bound": "unknown", "peaks": peaks}
    if wall_s and host_io_s and host_io_s >= HOST_IO_DOMINANCE * wall_s:
        out["bound"] = "host-io"
        out["host_io_s"] = host_io_s
        out["why"] = (
            f"host IO {host_io_s:.3f}s is "
            f"{host_io_s / wall_s:.0%} of the {wall_s:.3f}s wall "
            "(downloads / checkpoint waits dominate the kernels)"
        )
        return out
    if not flops or not bytes_accessed or flops <= 0 or bytes_accessed <= 0:
        out["why"] = (
            "no analytic cost captured for this solve "
            "(cost_analysis unavailable or capture disabled)"
        )
        return out
    t_hbm = bytes_accessed / (peaks["mem_gbps"] * 1e9)
    t_mxu = flops / (peaks["flops_gflops"] * 1e9)
    intensity = flops / bytes_accessed
    ridge = peaks["flops_gflops"] / peaks["mem_gbps"]  # FLOP per byte
    bound = "hbm" if t_hbm >= t_mxu else "mxu"
    out.update(
        bound=bound,
        t_hbm_s=t_hbm,
        t_mxu_s=t_mxu,
        intensity_flop_per_byte=intensity,
        ridge_flop_per_byte=ridge,
        roofline_floor_s=max(t_hbm, t_mxu),
    )
    if compute_s and compute_s > 0:
        # Fraction of the roofline the measured phases achieved; small
        # values mean overheads (launches, host reads, gathers the model
        # under-prices) dominate.
        out["roofline_frac"] = max(t_hbm, t_mxu) / compute_s
    out["why"] = (
        f"intensity {intensity:.2f} flop/byte vs ridge {ridge:.1f} -> "
        + (
            f"bandwidth floor {t_hbm * 1e3:.3f} ms >= compute floor "
            f"{t_mxu * 1e3:.3f} ms"
            if bound == "hbm"
            else f"compute floor {t_mxu * 1e3:.3f} ms > bandwidth floor "
            f"{t_hbm * 1e3:.3f} ms"
        )
    )
    return out


def attribute_stats(stats, *, platform: str, precision: str = "f32") -> dict:
    """Roofline-classify one completed solve from its SolverStats: the
    accumulated analytic cost (``stats.analytic_cost``) against the
    measured compute phases, with the pipeline's residual host-IO time
    competing for the bound; the compute peak is ``precision``'s."""
    g = lambda k, d=None: getattr(stats, k, d)  # noqa: E731
    phase_seconds = dict(g("phase_seconds", {}) or {})
    compute_s = sum(
        s for k, s in phase_seconds.items()
        if k in ("bellman_ford", "fanout", "batch_apsp")
    )
    wall_s = sum(phase_seconds.values())
    # Host IO that sat on the critical path: downloads + pipeline waits
    # minus what the overlap hid.
    host_io_s = max(
        0.0,
        float(g("download_s", 0.0) or 0.0)
        + float(g("ckpt_wait_s", 0.0) or 0.0)
        - float(g("overlap_saved_s", 0.0) or 0.0),
    )
    cost = g("analytic_cost") or {}
    return classify(
        flops=cost.get("flops"),
        bytes_accessed=cost.get("bytes_accessed"),
        compute_s=compute_s,
        host_io_s=host_io_s,
        wall_s=wall_s or None,
        platform=platform,
        precision=precision,
    )
