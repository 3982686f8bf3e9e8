"""The port's wire formats (`ops/wire.py`) against the JAX package's and
its numpy codecs, bit-exact, and the bf16 carrier through gloo.

fp32 and bf16: rows, grads with their count lanes, round trips; bf16
rounds to nearest even (`astype(bfloat16)` in XLA, the numpy codec's
bias trick). The carrier is int16 in the port, uint16 in JAX: the same
bits. Gloo and NCCL refuse int16 (and uint16), so the collectives move
such a tensor as an int8 view of its bytes: a two-rank all_to_all of
encoded rows and grads must arrive bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openembedding_tpu.ops import wire as jax_wire
from openembedding_tpu_torch.ops import wire
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_mesh_ranks as ranks


def _rows(seed, n=37, dim=10):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, dim)) * 10.0 ** rng.integers(-6, 6, (n, 1))
         ).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,  # ties
                        np.inf, -np.inf, 3.4e38], np.float32)
    x.reshape(-1)[:len(special)] = special
    return x


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("dim", [1, 9, 10, 64])
def test_row_codecs_are_bit_exact(fmt, dim):
    x = _rows(dim, dim=dim)
    enc = wire.pack_inband(torch.tensor(x), fmt)
    jenc = np.asarray(jax_wire.encode_rows(jnp.asarray(x), fmt))
    assert enc.dtype == wire.wire_carrier_dtype(fmt)
    assert enc.shape == (x.shape[0], wire.rows_wire_width(dim, fmt))
    np.testing.assert_array_equal(enc.numpy().view(jenc.dtype), jenc)
    np.testing.assert_array_equal(
        wire.np_encode_rows(x, fmt), jax_wire.np_encode_rows(x, fmt))
    np.testing.assert_array_equal(enc.numpy().view(jenc.dtype),
                                  wire.np_encode_rows(x, fmt))
    dec = wire.unpack_inband(enc, dim, fmt).numpy()
    jdec = np.asarray(jax_wire.decode_rows(jnp.asarray(jenc), dim, fmt))
    np.testing.assert_array_equal(dec.view(np.uint32), jdec.view(np.uint32))
    np.testing.assert_array_equal(
        wire.np_decode_rows(jenc, dim, fmt).view(np.uint32),
        jdec.view(np.uint32))


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_grad_payloads_and_count_lanes_are_bit_exact(fmt):
    g = _rows(3)
    counts = np.array([0, 1, 2, 7, 65535, 65536, 2 ** 31 - 1]
                      + list(range(30)), np.int32)[:g.shape[0]]
    enc = wire.encode_grads(torch.tensor(g), torch.tensor(counts), fmt)
    jenc = np.asarray(jax_wire.encode_grads(jnp.asarray(g),
                                            jnp.asarray(counts), fmt))
    assert enc.shape[1] == wire.grads_wire_width(g.shape[1], fmt) \
        == jax_wire.grads_wire_width(g.shape[1], fmt)
    assert wire.count_lanes(fmt) == jax_wire.count_lanes(fmt)
    np.testing.assert_array_equal(enc.numpy().view(jenc.dtype), jenc)
    rg, rc = wire.decode_grads(enc, g.shape[1], fmt)
    jg, jc = jax_wire.decode_grads(jnp.asarray(jenc), g.shape[1], fmt)
    np.testing.assert_array_equal(rg.numpy().view(np.uint32),
                                  np.asarray(jg).view(np.uint32))
    np.testing.assert_array_equal(rc.numpy(), counts)
    np.testing.assert_array_equal(np.asarray(jc), counts)
    lanes = wire.counts_to_lanes(torch.tensor(counts), fmt)
    np.testing.assert_array_equal(
        lanes.numpy().view(np.uint8),
        np.asarray(jax_wire.counts_to_lanes(jnp.asarray(counts),
                                            fmt)).view(np.uint8))
    np.testing.assert_array_equal(wire.lanes_to_counts(lanes).numpy(), counts)


def test_empty_slots_decode_to_zero_grads_and_counts():
    for fmt in ("fp32", "bf16"):
        z = torch.zeros((3, wire.grads_wire_width(9, fmt)),
                        dtype=wire.wire_carrier_dtype(fmt))
        g, c = wire.decode_grads(z, 9, fmt)
        assert not g.any() and not c.any()


def test_format_resolution_and_int8(monkeypatch):
    monkeypatch.setenv("OETPU_WIRE", "")
    assert wire.wire_format() == jax_wire.wire_format() == "bf16"
    assert wire.wire_format("float32") == "fp32"
    monkeypatch.setenv("OETPU_WIRE", "BFLOAT16")
    assert wire.wire_format() == jax_wire.wire_format() == "bf16"
    assert wire.wire_format("fp32") == "fp32"
    with pytest.raises(ValueError, match="unknown wire format"):
        wire.wire_format("fp8")
    assert wire.wire_format("int8") == "int8"
    for call in (lambda: wire.pack_inband(torch.zeros(2, 3), "int8"),
                 lambda: wire.rows_wire_width(3, "int8"),
                 lambda: wire.np_encode_rows(np.zeros((2, 3)), "int8")):
        with pytest.raises(NotImplementedError, match="item 3"):
            call()


def test_the_bf16_carrier_crosses_gloo_bit_for_bit(tmp_path):
    x = _rows(5, n=8, dim=10)
    counts = np.arange(8, dtype=np.int32) * 40503
    out = run_local(ranks.exchange_encoded, 2, args=(x, counts), timeout_s=60,
                    tmp_dir=str(tmp_path))
    for r in range(2):
        sent = [wire.encode_grads(torch.tensor(x) * (s + 1),
                                  torch.tensor(counts), "bf16")
                for s in range(2)]
        want = torch.stack([sent[s].reshape(2, 4, -1)[r] for s in range(2)])
        assert out[r]["dtype"] == "torch.int16"
        np.testing.assert_array_equal(out[r]["recv"], want.numpy())
        np.testing.assert_array_equal(out[r]["counts"],
                                      np.concatenate([counts[4 * r:4 * r + 4]]
                                                     * 2))

