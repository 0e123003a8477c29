"""Layer kernel: FastConformer activation pass (csrc/activation_pass.cu):
the kernel's share of its roofline over the traced job's launches (%).  Its
least time is the bytes the activation passes must move for the calls' own
frames (the sum of ``fastconformer.activation_bytes``: per frame and layer
6 an element of d_ff for each feed-forward's SiLU, which reads the float32
product and writes bf16, 10 an element of d_model for the GLU, which reads
both float32 halves, and 4 for batch norm and SiLU over the bf16
convolution) at the card's memory bandwidth.  Its time is the sum of the
launches' device times, which compute every row of the padded batch, so
the share stays below the batches' useful share of frames.  None where no
launch ran (a program without the kernel)."""

from harness.program_spans import events

KERNEL = "activation_pass_kernel"   # csrc/activation_pass.cu's __global__ function


def read(r):
    launches = r.ops_named(KERNEL)
    moved = sum(e.n for e in events(r)
                if hasattr(e, "t_ns") and e.name == "fastconformer.activation_bytes")
    if not launches or not moved or r.peaks is None:
        return None
    seconds = sum(op.dur_ns for op in launches) / 1e9
    return 100.0 * moved / r.peaks["hbm_bytes"] / seconds
