"""Layer kernel: FastConformer relative-position attention
(csrc/rel_attention.cu): the kernel's share of its roofline over the traced
job's launches (%).  Its least time is the useful operations at the card's
bf16 peak: 6 d_model per query-key pair of the calls' own (the sum of
``fastconformer.attention_pairs``): 2 for the content score, 2 for the
position score (one d_head dot per pair and head) and 2 for the weight
times V.  (harness/flops_fastconformer.py counts 8, for NeMo's product of
each query with all 2T - 1 positions, which the kernel does not run.)  Its
time is the sum of the launches' device times.  None where no launch ran."""

from harness.program_spans import events

KERNEL = "rel_attention_kernel"   # csrc/rel_attention.cu's __global__ function


def read(r):
    launches = r.ops_named(KERNEL)
    pairs = sum(e.n for e in events(r)
                if hasattr(e, "t_ns") and e.name == "fastconformer.attention_pairs")
    if not launches or not pairs or r.peaks is None:
        return None
    seconds = sum(op.dur_ns for op in launches) / 1e9
    return 100.0 * 6 * r.sizes.d_model * pairs / r.peaks["bf16_flops"] / seconds
