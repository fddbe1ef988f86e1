"""The comparison that decides ``correct`` fails where it must.

Each test drives the rest of a run on the CPU (the look for a card is the
only part skipped) with the timed path broken underneath, and sees
``correct`` come out false: a decode that leaves its output as it found it,
half of a field left out, an answer altered where it is produced (a decoded
value, a blob byte), an input overwritten with its own reconstruction,
which the reference would otherwise judge as exact.  The control puts the plain reference in the program's
place, computed in bfloat16 one step below the configurations' float32: it
fails too, while the same reference in float32 passes.  A cell has one card,
so no exchange between cards can be left out.
"""
import pytest
import torch

from portbench.harness import session
from portbench.harness.program import PortProgram
from portbench.reference import sz3_bound


class _Broken(PortProgram):
    fault = None

    def compress(self, x):
        if self.fault == "half":
            rows = x.shape[0] // 2
            blob, _ = super().compress(x[:rows].contiguous())
            return blob, x.numel() * x.element_size() / len(blob)
        blob, ratio = super().compress(x)
        if self.fault == "input_overwritten":
            x.copy_(super().decompress(blob))
        if self.fault == "blob_byte":
            i = len(blob) // 2
            blob = blob[:i] + bytes([blob[i] ^ 0x40]) + blob[i + 1 :]
        return blob, ratio

    def decompress(self, blob):
        out = super().decompress(blob)
        if self.fault == "unchanged":
            return torch.zeros_like(out)
        if self.fault == "value":
            out = out.clone()
            flat = out.view(-1)
            flat[flat.numel() // 3] += 1e3 * float(flat.abs().max() + 1)
        if self.fault == "half":
            full = torch.zeros((out.shape[0] * 2, *out.shape[1:]), dtype=out.dtype)
            full[: out.shape[0]] = out
            return full
        return out


def _factory(fault):
    def make(traffic, device):
        prog = _Broken(traffic, device)
        prog.fault = fault
        return prog

    return make


@pytest.mark.parametrize("fault", ["unchanged", "half", "value", "blob_byte", "input_overwritten"])
def test_each_fault_comes_out_not_correct(tiny, fault):
    catalog, bench = tiny
    for cell in (w["name"] for w in bench["workloads"]):
        result = session.run_cell(catalog, cell, 41, 0.0, False, device="cpu", program_factory=_factory(fault))
        assert result["correct"] is False, (cell, fault, result["checks"])
        assert result["failed"] > 0


def test_the_unbroken_program_is_correct(tiny):
    catalog, bench = tiny
    for cell in (w["name"] for w in bench["workloads"]):
        assert session.run_cell(catalog, cell, 41, 0.0, False, device="cpu", program_factory=_factory(None))["correct"]


class _Reference(PortProgram):
    """The plain reference in the program's place: the port writes the blob
    (so its structure is judged as ever), the decode is the plain codec's."""

    dtype = torch.float32

    def __init__(self, traffic, device):
        super().__init__(traffic, device)
        self.mode, self.eb, self.inputs = traffic["mode"], float(traffic["eb"]), {}

    def compress(self, x):
        blob, ratio = super().compress(x)
        self.inputs[blob] = x
        return blob, ratio

    def decompress(self, blob):
        x = self.inputs.pop(blob)
        return sz3_bound.plain_codec(x, sz3_bound.abs_bound(x, self.mode, self.eb), self.dtype)


@pytest.mark.parametrize("dtype, correct", [(torch.float32, True), (torch.bfloat16, False)])
def test_control_one_precision_below_fails(tiny, dtype, correct):
    catalog, bench = tiny

    def make(traffic, device):
        prog = _Reference(traffic, device)
        prog.dtype = dtype
        return prog

    for cell in (w["name"] for w in bench["workloads"]):
        result = session.run_cell(catalog, cell, 43, 0.0, False, device="cpu", program_factory=make)
        assert result["correct"] is correct, (cell, dtype, result["checks"])
        if not correct:
            assert result["checks"]["err_over_bound"]["value"] > 3.0
