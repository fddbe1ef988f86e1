"""The Huffman stream pack (``repro_torch.kernels.huffman``) and the coder's
tensor path (``HuffmanEncoder.encode_tensor``).

On the CPU the wrapper runs the plain torch version; it is held byte for
byte against the host coder's ``_encode_stream``, and the tensor path's
blobs against the numpy path's and the JAX package's.  The CUDA kernel is
held against the plain version in the ``cuda``-marked tests, which skip
where there is no card.  JAX is imported inside the one test that compares
with it, so the ``cuda`` tests also run on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_huffman_pack.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encoders as E
from repro_torch.core import pipeline as P
from repro_torch.core import telemetry as tel
from repro_torch.kernels.huffman import ops, ref

SIZES = [0, 1, 1023, 1024, 1025, 3 * 1024 + 7, 100_003]
ALPHABETS = ["one", "two", "normal", "long"]
DTYPES = [torch.int32, torch.int64]


def _fib_codes(n: int) -> np.ndarray:
    """n codes over at most 17 values, value i Fibonacci(i + 1) times and
    the last value the rest: a chain-shaped Huffman tree, 16 deep from
    n = 4,179 on, so codes of the longest length the coder allows."""
    fib = [1, 1]
    while len(fib) < 16 and sum(fib) + fib[-1] + fib[-2] <= n:
        fib.append(fib[-1] + fib[-2])
    counts = fib + [max(0, n - sum(fib))]
    return np.repeat(np.arange(len(counts)), counts)[:n]


def codes_of(alphabet: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    if alphabet == "one":
        return np.full(n, 32768, np.uint16)
    if alphabet == "two":
        return rng.choice(np.array([0, 5], np.uint16), n)
    if alphabet == "normal":  # as test_huffman_same_bytes_and_reads_reference_streams
        codes = (32768 + np.rint(rng.normal(scale=30, size=n))).astype(np.uint16)
        codes[::97] = 0
        return codes
    return rng.permutation(_fib_codes(n)).astype(np.uint16)


def host_stream(codes: np.ndarray):
    """(vals, table, stream bytes of version 1, version 2) of the numpy path."""
    vals, freqs, inv = E._alphabet_of(codes)
    lens, _ = E._huffman_code_lengths(freqs)
    table = E._cached_table(lens)
    return vals, lens, table, E._encode_stream(inv, table, 1), E._encode_stream(inv, table, 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "int64"])
@pytest.mark.parametrize("alphabet", ALPHABETS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_pack_equals_encode_stream(n, alphabet, dtype):
    codes = codes_of(alphabet, n)
    if n == 0:
        payload, sync, total = ops.pack(torch.zeros(0, dtype=dtype), torch.zeros(1, dtype=torch.int32))
        assert (payload.numel(), sync.numel(), total) == (0, 0, 0)
        return
    vals, _, table, v1, v2 = host_stream(codes)
    payload, sync, total = ops.pack(torch.from_numpy(codes.astype(np.int64)).to(dtype),
                                    torch.from_numpy(E._pack_table(vals, table)))
    n_h, total_h, sync_h, pos = E._parse_stream_head(v2, 0)
    assert (n_h, total_h) == (n, total)
    np.testing.assert_array_equal(sync.numpy(), sync_h)
    assert payload.dtype == torch.uint8 and payload.numpy().tobytes() == v2[pos:]
    assert E._stream_bytes(n, total, sync.numpy(), payload.numpy().tobytes(), 1) == v1
    assert E._stream_bytes(n, total, sync.numpy(), payload.numpy().tobytes(), 2) == v2


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "int64"])
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_encode_tensor_writes_the_numpy_paths_and_the_references_blob(alphabet, dtype, version):
    from repro.core import encoders as r_enc

    codes = codes_of(alphabet, 100_003, seed=version)
    if alphabet == "long":
        assert int(host_stream(codes)[1].max()) == 16  # the case the cap shapes
    want = E.HuffmanEncoder(stream_version=version).encode(codes)
    assert want == r_enc.HuffmanEncoder(stream_version=version).encode(codes)
    t = torch.from_numpy(codes.astype(np.int64)).to(dtype)
    host, got = E.HuffmanEncoder(stream_version=version).encode_tensor(t, np.uint16)
    assert got == want
    assert host.dtype == np.uint16 and np.array_equal(host, codes)
    assert E.HuffmanEncoder(stream_version=version).encode(t[:98000].reshape(-1, 7)) == (
        E.HuffmanEncoder(stream_version=version).encode(codes[:98000]))
    legacy = E.LegacyHuffmanEncoder().encode(t)
    assert legacy == E.HuffmanEncoder(stream_version=1).encode(codes)
    np.testing.assert_array_equal(E.HuffmanEncoder().decode(got, codes.size), codes)


@pytest.mark.parametrize(
    "values",
    [[-3, 1, 2], [1, 2, 1 << 22], [0, 1, 1 << 40], [3.0, 1.5, 2.0], []],
    ids=["negative", "hist-max", "huge", "float", "empty"],
)
def test_encode_tensor_outside_the_histogram_takes_the_host_path(values):
    arr = np.asarray(values)
    t = torch.tensor(values, dtype=torch.float64 if arr.dtype.kind == "f" else torch.int64)
    host, got = E.HuffmanEncoder().encode_tensor(t)
    assert got == E.HuffmanEncoder().encode(arr) and np.array_equal(host, arr)


@pytest.mark.parametrize("case", ["above-table", "negative", "not-in-alphabet"])
def test_plain_pack_raises_outside_the_alphabet(case):
    codes = codes_of("normal", 5000)
    vals, _, table, _, _ = host_stream(codes)
    dense = torch.from_numpy(E._pack_table(vals, table))
    bad = torch.from_numpy(codes.astype(np.int64))
    assert int(dense[1]) == 0  # 1 is no code of this alphabet
    bad[4321] = {"above-table": dense.numel(), "negative": -1, "not-in-alphabet": 1}[case]
    with pytest.raises(ValueError, match="outside Huffman alphabet"):
        ops.pack(bad, dense)


def _spans(tr, name):
    out, stack = [], list(tr.root.children)
    while stack:
        s = stack.pop()
        out += [s] if s.name == name else []
        stack += s.children
    return out


def assert_span_bytes(tr, names, nbytes):
    for name in names:
        spans = _spans(tr, name)
        assert spans and all(int(s.attrs["bytes"]) == nbytes for s in spans), name


@pytest.mark.parametrize("path", ["numpy", "tensor", "tensor-int64", "pipeline-cpu"])
def test_spans_count_the_codes_bytes(path):
    """Both halves count n x the quantizer's code dtype (codes in) on every
    path, whatever dtype the codes had before the cast."""
    codes = codes_of("normal", 30_000)
    t = torch.from_numpy(codes.astype(np.int64 if path == "tensor-int64" else np.int32))
    with tel.trace("t") as tr:
        if path == "numpy":
            E.HuffmanEncoder().encode(codes)
        elif path == "pipeline-cpu":
            P._encode_codes(E.HuffmanEncoder(), t, np.uint16)
        else:
            E.HuffmanEncoder().encode_tensor(t, np.uint16)
    names = ("huffman_table", "huffman_pack") + (("huffman",) if path == "pipeline-cpu" else ())
    assert_span_bytes(tr, names, codes.size * 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "int64"])
@pytest.mark.parametrize("alphabet", ALPHABETS)
@pytest.mark.parametrize("n", SIZES + [1 << 20, (1 << 20) + 1, 5_000_001])
def test_cuda_pack_equals_plain(cuda_device, n, alphabet, dtype):
    from repro_torch.kernels.huffman import kernel as K

    codes = codes_of(alphabet, n)
    dense = torch.zeros(1, dtype=torch.int32)
    if n:
        vals, _, table, _, _ = host_stream(codes)
        dense = torch.from_numpy(E._pack_table(vals, table))
    t = torch.from_numpy(codes.astype(np.int64)).to(dtype)
    want = ref.pack(t, dense)
    K.reset_launches()
    got = ops.pack(t.to(cuda_device), dense.to(cuda_device))
    torch.cuda.synchronize()
    assert K.LAUNCHES["pack"] == int(n > 0)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    # an unaligned view takes the kernel's scalar loads
    if n > 1:
        shifted = torch.cat([t[:1], t]).to(cuda_device)[1:]
        again = ops.pack(shifted, dense.to(cuda_device))
        assert again[2] == want[2] and torch.equal(again[0].cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["above-table", "negative", "not-in-alphabet"])
def test_cuda_pack_raises_outside_the_alphabet(cuda_device, case):
    codes = codes_of("normal", 5000)
    vals, _, table, _, _ = host_stream(codes)
    dense = torch.from_numpy(E._pack_table(vals, table))
    bad = torch.from_numpy(codes.astype(np.int32))
    bad[4321] = {"above-table": dense.numel(), "negative": -1, "not-in-alphabet": 1}[case]
    with pytest.raises(ValueError, match="outside Huffman alphabet"):
        ops.pack(bad.to(cuda_device), dense.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_cuda_encode_codes_writes_the_numpy_paths_blob(cuda_device, version):
    """The pipeline's hand-over: codes on the card reach the kernel, the
    blob and the host copy are the numpy path's, the spans count codes in."""
    from repro_torch.kernels.huffman import kernel as K

    codes = codes_of("normal", 2_000_003, seed=version)
    want = E.HuffmanEncoder(stream_version=version).encode(codes)
    K.reset_launches()
    with tel.trace("t") as tr:
        host, got = P._encode_codes(E.HuffmanEncoder(stream_version=version),
                                    torch.from_numpy(codes.astype(np.int32)).to(cuda_device), np.uint16)
    assert got == want and host.dtype == np.uint16 and np.array_equal(host, codes)
    assert K.LAUNCHES["pack"] == 1
    assert_span_bytes(tr, ("huffman", "huffman_table", "huffman_pack"), codes.size * 2)
