"""The FLOP and byte arithmetic against the flagship's worked counts."""

from benchmark import costs, spec

B, F, ND = 4096, 26, 13


def _cfg(name):
    return spec.config(spec.load(), name)


def test_flagship_flops():
    cfg = _cfg("deepfm_d9")
    # (13 x 1) + (247 x 400) + (400 x 400) x 2 + (400 x 1) multiply-adds an
    # example: 419,213; times 2 operations, times 3 for forward + backward
    assert costs.tower_layers(cfg, ND, F)[1] == (13 + 26 * 9, 400)
    assert costs.step_flops(cfg, B, ND, F) == 6 * B * 419_213
    assert abs(costs.step_flops(cfg, B, ND, F) - 10.30e9) < 0.01e9


def test_flagship_bytes():
    cfg = _cfg("deepfm_d9")
    n, u = B * F, 80_000
    assert costs.row_bytes(cfg) == 40
    assert costs.gather_bytes(cfg, n, u) == n * 8 + u * 40 + n * 40
    assert costs.apply_bytes(cfg, u) == u * 212
    params = 13 + 1 + 247 * 400 + 400 + 2 * (400 * 400 + 400) + 400 + 1
    assert costs.dense_params(cfg, ND, F) == params
    inputs = B * (26 * 8 + 13 * 4 + 4)
    assert costs.step_bytes(cfg, B, ND, F, u) == (inputs + u * 160
                                                   + params * 16)
    hashed = _cfg("deepfm_d9_hashed")
    assert (costs.step_bytes(hashed, B, ND, F, u)
            == costs.step_bytes(cfg, B, ND, F, u) + u * 8)


def test_least_time_names_its_bound():
    kind = "NVIDIA H100 80GB HBM3"
    t, bound = costs.least_seconds(989e12, 1.0, kind)
    assert bound == "flops" and abs(t - 1.0) < 1e-12
    t, bound = costs.least_seconds(1.0, 3.35e12, kind)
    assert bound == "bytes" and abs(t - 1.0) < 1e-12
