"""Layer kernel: FastConformer residual-and-norm junction
(csrc/norm_junction.cu): the kernel's share of its roofline over the traced
job's launches (%).  Its least time is the bytes the junctions must move
for the calls' own frames (the sum of ``fastconformer.junction_bytes``: per
element of d_model 10 for a junction that reads the float32 product and
the bf16 stream and writes two bf16 rows, 8 for the last layer's, 4 for
the first norm alone) at the card's memory bandwidth.  Its time is the sum
of the launches' device times, which compute every row of the padded
batch, so the share stays below the batches' useful share of frames.
None where no launch ran."""

from harness.program_spans import events

KERNEL = "norm_junction_kernel"   # csrc/norm_junction.cu's __global__ function


def read(r):
    launches = r.ops_named(KERNEL)
    moved = sum(e.n for e in events(r)
                if hasattr(e, "t_ns") and e.name == "fastconformer.junction_bytes")
    if not launches or not moved or r.peaks is None:
        return None
    seconds = sum(op.dur_ns for op in launches) / 1e9
    return 100.0 * moved / r.peaks["hbm_bytes"] / seconds
