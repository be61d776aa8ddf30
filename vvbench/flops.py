"""Operations and bytes of the benchmark's work, from the configurations'
shapes alone (never read from a kernel), and the published peaks of one
NVIDIA H100 SXM (dense): a roofline or an `mfu` reads the same work
whatever implements it.

A least time is the larger of operations over the peak rate and bytes over
the HBM bandwidth, each input byte read once and each output written once.
"""

from __future__ import annotations

PEAK_BF16 = 989e12       # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12         # FLOP/s, FFMA outside the tensor cores
PEAK_BYTES = 3.35e12     # B/s, HBM3

BYTES = {"bfloat16": 2, "float32": 4}


def least_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES)


def gemm(m: int, k: int, n: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of (m, k) . (k, n) + an f32 bias, with `dtype`
    operands and an f32 output."""
    e = BYTES[dtype]
    return 2.0 * m * k * n, float((m * k + k * n) * e + m * n * 4 + n * 4)


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def _pooled(size: int) -> int:
    # Caffe's 3x3/2 max pool rounds up
    return -(-(size - 3) // 2) + 1


def caffenet_convs(batch: int, cfg: dict) -> list[dict]:
    """Per conv of conv1..conv5: name, operations and bytes (NHWC input in
    the compute dtype, HWIO weights, f32 bias, output in the compute
    dtype), for `batch` frames of cfg["crop"] pixels square."""
    e = BYTES[cfg["compute_dtype"]]
    size, c_in = cfg["crop"], 3
    out = []
    for spec in cfg["convs"]:
        k, o, g = spec["kernel"], spec["num_output"], spec["group"]
        ho = _out(size, k, spec["stride"], spec["pad"])
        ops = 2.0 * batch * ho * ho * o * k * k * (c_in // g)
        nbytes = (batch * size * size * c_in * e + k * k * (c_in // g) * o * e
                  + o * 4 + batch * ho * ho * o * e)
        out.append({"name": spec["name"], "ops": ops, "bytes": float(nbytes)})
        size, c_in = (_pooled(ho) if spec["pool"] else ho), o
    return out


def caffenet_fc_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(k, n) of fc6, fc7 and the tower."""
    size, c_in = cfg["crop"], 3
    for spec in cfg["convs"]:
        size = _out(size, spec["kernel"], spec["stride"], spec["pad"])
        size = _pooled(size) if spec["pool"] else size
        c_in = spec["num_output"]
    return [(size * size * c_in, cfg["fc6"]), (cfg["fc6"], cfg["fc7"]),
            (cfg["fc7"], cfg["embed_dim"])]


def caffenet_frame_ops(cfg: dict, tower: bool = True) -> float:
    """Operations of one frame through conv1..fc7 (and the tower)."""
    convs = sum(c["ops"] for c in caffenet_convs(1, cfg))
    fcs = caffenet_fc_shapes(cfg)[:3 if tower else 2]
    return convs + sum(2.0 * k * n for k, n in fcs)


def k2_least_s(batch: int, cfg: dict) -> float:
    return sum(least_s(c["ops"], c["bytes"], PEAK_BF16)
               for c in caffenet_convs(batch, cfg))


def k1_query_least_s(batch: int, cfg: dict) -> float:
    """fc6, fc7 and the tower at `batch` rows, compute-dtype operands, f32
    out, f32 bias."""
    return sum(least_s(*gemm(batch, k, n, cfg["compute_dtype"]), PEAK_BF16)
               for k, n in caffenet_fc_shapes(cfg))


def score_ops(batch: int, gallery: int, dim: int) -> float:
    return 2.0 * batch * gallery * dim


def query_least_s(batch: int, gallery: int, cfg: dict) -> float:
    """CaffeNet and the tower at the compute dtype's peak, plus the f32
    scores (TF32 off) at the f32 peak."""
    return (batch * caffenet_frame_ops(cfg) / PEAK_BF16
            + score_ops(batch, gallery, cfg["embed_dim"]) / PEAK_F32)


def tower_rows(cfg: dict) -> int:
    """Rows of the training tower's product: the batch's windows times the
    1 + C + N roles."""
    return cfg["batch_size"] * (cfg["context_size"] + cfg["num_negatives"])


def train_step_ops(cfg: dict) -> float:
    """The tower forward and its weight gradient (its input takes none)."""
    return 4.0 * tower_rows(cfg) * cfg["feature_dim"] * cfg["embed_dim"]


def test_eval_ops(cfg: dict) -> float:
    """The TEST tower over the test batch and its (N, N) distance product."""
    n = cfg["test_batch"]
    return (2.0 * n * cfg["feature_dim"] * cfg["embed_dim"]
            + 2.0 * n * n * cfg["embed_dim"])


def k1_train_least_s(cfg: dict, steps: int, evals: int) -> float:
    """K1's work in a window of `steps` steps and `evals` test evals: the
    tower forward a step and the TEST tower an eval, f32 (the prototxt's
    type) at the f32 peak."""
    d, e = cfg["feature_dim"], cfg["embed_dim"]
    step = least_s(*gemm(tower_rows(cfg), d, e, "float32"), PEAK_F32)
    test = least_s(*gemm(cfg["test_batch"], d, e, "float32"), PEAK_F32)
    return steps * step + evals * test
