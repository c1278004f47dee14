"""The Python around the gather kernel (`kernels/gather.py`), on the CPU.

`csrc/gather.cu` stages one index row and the `rep` value rows it serves in
shared memory, at the 16-byte phase of each row's start, and writes 16-byte
stores with a scalar head and tail. The card tests hold the kernel itself
to `torch.gather` (`tests/test_torch_port_cuda.py`); these hold what the
wrapper decides and the design's index arithmetic: the shared-memory limit
rule, the `(rep, inner)` row map at the shapes `ops/fills.py` and
`ops/polylines.py` pass, and a model of the kernel's staging and stores
over element offsets, all bit-equal to `torch.gather` (and to JAX's
`take_along_axis`, what the JAX package computes off the TPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu_torch.kernels import gather as tgather

# (values shape, index shape) of the callers at 1080p, batch 12: fills' and
# polylines' keys, prefix sums and points, the [B, 1, H, W] colour planes of
# both, polylines' search over a prefix of W + 1 slots; and a 4K frame.
CALLER_SHAPES = [
    ((12, 1080, 1920), (12, 1080, 1920)),
    ((12, 3, 1080, 1920), (12, 1, 1080, 1920)),
    ((12, 1080, 1921), (12, 1080, 1920)),
    ((1, 3, 2160, 3840), (1, 1, 2160, 3840)),
]


@pytest.mark.parametrize("vshape,ishape", CALLER_SHAPES)
def test_caller_shapes_fit_in_shared_memory(vshape, ishape):
    rep, inner = tgather._broadcast_rows(vshape[:-1], ishape[:-1])
    assert (rep, inner) == ((1, 1) if len(vshape) == 3 else (3, vshape[2]))
    need = tgather.smem_bytes(vshape[-1], ishape[-1], rep)
    assert need <= tgather.SMEM_LIMIT
    assert tgather.staged(vshape[-1], ishape[-1], rep)


@pytest.mark.parametrize("rep,largest", [(1, 29053), (3, 14525)])
def test_shared_memory_limit_rule(rep, largest):
    """Rows up to `largest` columns (M = N) are staged in shared memory; one
    more goes to the kernel's direct instance."""
    assert tgather.smem_bytes(largest, largest, rep) <= tgather.SMEM_LIMIT
    assert tgather.staged(largest, largest, rep)
    assert tgather.smem_bytes(largest + 1, largest + 1, rep) > tgather.SMEM_LIMIT
    assert not tgather.staged(largest + 1, largest + 1, rep)


@pytest.mark.parametrize("m,slot", [(1, 4), (2, 8), (4, 8), (5, 8), (6, 12), (1920, 1924),
                                    (1921, 1924), (1922, 1928)])
def test_staged_row_slot(m, slot):
    """A row of m words takes room for m words after up to 3 words of
    phase, in whole 16-byte chunks."""
    assert tgather.smem_bytes(m, 0, 1) == 4 * (slot + 4)
    assert slot % 4 == 0 and slot >= m + 3


def _kernel_model(values, v_off, idx, i_off, o_off, m, n, rep, inner):
    """What csrc/gather.cu computes, on flat int32 storage where the rows'
    data start at element offsets v_off, i_off and o_off (4-byte words from
    a 16-byte boundary): one CTA per index row, each row staged at its
    phase, the body in 16-byte stores and the head and tail word by word."""
    rows = (values.size - v_off) // m
    out = np.full(o_off + rows * n, -7, np.int32)

    def staged(storage, start, count):
        phase = start % 4
        slot = (count + 6) // 4 * 4
        buf = np.full(slot, -9, np.int32)
        head = min((4 - phase) % 4, count)
        body = (count - head) // 4
        for w in range(head + 4 * body, count):
            buf[phase + w] = storage[start + w]
        for w in range(head):
            buf[phase + w] = storage[start + w]
        for c in range(body):
            w = head + 4 * c
            assert (phase + w) % 4 == 0
            buf[phase + w:phase + w + 4] = storage[start + w:start + w + 4]
        return buf[phase:phase + count]

    for ir in range(rows // rep):
        first = (ir // inner) * rep * inner + ir % inner
        si = staged(idx, i_off + ir * n, n)
        for c in range(rep):
            r = first + c * inner
            sv = staged(values, v_off + r * m, m)
            start = o_off + r * n
            head = min((4 - start % 4) % 4, n)
            body = (n - head) // 4
            for j in list(range(head)) + list(range(head + 4 * body, n)):
                out[start + j] = sv[si[j]]
            for b in range(body):
                j = head + 4 * b
                assert (start + j) % 4 == 0
                out[start + j:start + j + 4] = sv[si[j:j + 4]]
    return out[o_off:].reshape(rows, n)


@pytest.mark.parametrize("lead_v,lead_i,m,n,offs", [
    ((2, 6), (2, 6), 40, 40, (0, 0, 0)),       # fills' keys, aligned rows
    ((2, 6), (2, 6), 41, 40, (0, 0, 0)),       # polylines' W + 1 prefix
    ((2, 3, 5), (2, 1, 5), 40, 40, (0, 0, 0)),  # a colour plane, rep = 3
    ((2, 3, 5), (2, 1, 5), 37, 30, (0, 0, 0)),  # M != N, N % 4 != 0
    ((2, 3, 5), (2, 1, 5), 40, 40, (1, 3, 2)),  # views at element offsets
    ((3, 7), (3, 7), 301, 257, (1, 1, 0)),
    ((2, 3, 4), (2, 1, 4), 5, 3, (2, 0, 1)),   # rows shorter than a chunk
])
def test_kernel_model_matches_gather(lead_v, lead_i, m, n, offs):
    rng = np.random.default_rng(m * n)
    v_off, i_off, o_off = offs
    values = rng.integers(-2 ** 31, 2 ** 31 - 1, v_off + int(np.prod(lead_v)) * m,
                          dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, m, i_off + int(np.prod(lead_i)) * n).astype(np.int32)
    vt = torch.from_numpy(values[v_off:].reshape(lead_v + (m,)))
    it = torch.from_numpy(idx[i_off:].reshape(lead_i + (n,)))
    rep, inner = tgather._broadcast_rows(lead_v, lead_i)
    got = _kernel_model(values, v_off, idx, i_off, o_off, m, n, rep, inner)
    want = tgather.bounded_take_along_w(vt, it, m)
    assert torch.equal(torch.from_numpy(got).reshape(want.shape), want)
    jax_out = np.asarray(jnp.take_along_axis(
        jnp.asarray(vt.numpy()), jnp.asarray(np.broadcast_to(it.numpy(), want.shape)), axis=-1))
    np.testing.assert_array_equal(want.numpy(), jax_out)


def test_binary_search_pattern_is_gather():
    """The fills' searches gather sorted keys at midpoints anywhere in the
    row window; the staged row serves any column."""
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 500, (4, 9, 300)), axis=-1).astype(np.int32)
    mid = rng.integers(0, 300, (4, 9, 300)).astype(np.int32)
    got = tgather.bounded_take_along_w(torch.from_numpy(keys), torch.from_numpy(mid), 8)
    want = np.take_along_axis(keys, mid.astype(np.int64), axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    model = _kernel_model(keys.ravel(), 0, mid.ravel(), 0, 0, 300, 300, 1, 1)
    np.testing.assert_array_equal(model.reshape(want.shape), want)
