"""One chunked optimizer moment of the checkpoint phase (Qwen1.5-0.5B's
embedding second moment, 151,936 x 1,024 float32) decoded on the card four
ways in turns, three rounds: ``checkpoint.decode_leaf``,
``elastic.restore_leaf_resharded`` (all rows by chunk range), chunk by chunk
into a preallocated output, and every chunk kept then concatenated.  Each
result must equal the first; prints the seconds of each way.

    python3 tools/elastic_rows_ab.py        # from the repository root, with one H100
"""
import json, pathlib, sys, time
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs
import torch
smi = cs.phase_environment()
cs.phase_build()
from repro_torch.ft import checkpoint as ck, elastic as te
from repro_torch.core.chunking import decompress_chunk, parse_chunked_index
from repro_torch.parallel import ParallelPlan
state = cs._ckpt_state(0)
t = state["opt"]["v"]["embed"]
t0 = time.perf_counter()
blob, meta = ck.encode_leaf(t, ck.CheckpointPolicy().for_path("opt/v/embed"))
enc_s = time.perf_counter() - t0
del state
n = meta["shape"][0]

def sync_time(fn):
    torch.cuda.synchronize(); t0 = time.perf_counter(); out = fn(); torch.cuda.synchronize()
    return time.perf_counter() - t0, out

def prealloc():
    idx = parse_chunked_index(blob)
    out = torch.empty(meta["shape"], dtype=torch.float32, device="cuda")
    pos = 0
    for i in range(idx.n_chunks):
        part = decompress_chunk(blob, i, parsed=idx, device="cuda")
        k = part.shape[0]
        out[pos:pos + k] = part.reshape(k, -1)
        pos += k
    return out

def keep_all():
    idx = parse_chunked_index(blob)
    parts = [decompress_chunk(blob, i, parsed=idx, device="cuda") for i in range(idx.n_chunks)]
    return torch.cat([p.reshape(p.shape[0], -1) for p in parts])

res = {"encode_s": enc_s, "bytes": len(blob), "chunks": parse_chunked_index(blob).n_chunks}
ways = {"decode_leaf": lambda: ck.decode_leaf(blob, meta, device="cuda"),
        "restore_leaf_resharded": lambda: te.restore_leaf_resharded(blob, meta, ParallelPlan(), (), device="cuda")[0],
        "decompress_chunk_prealloc": prealloc, "decompress_chunk_keep_cat": keep_all}
ref = None
for turn in range(3):
    for name in (list(ways) if turn % 2 == 0 else list(reversed(ways))):
        s, out = sync_time(ways[name])
        res.setdefault(name, []).append(s)
        if ref is None:
            ref = out
        assert torch.equal(out, ref), name
        del out
        torch.cuda.empty_cache()
print(json.dumps(res))
print(smi)
