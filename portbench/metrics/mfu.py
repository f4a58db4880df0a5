"""Model FLOPs of the window's steps (`harness/counts.py`: a training
micro-step's forward x 3, one routed expert a token, the pairs the masks
allow; a search call's prompt forward and its decode steps' beams) over the
window's seconds times the card's bf16 peak, in %."""

from portbench.harness import counts


def read(run):
    if not getattr(run, "flops", None):
        return None
    return 100.0 * run.flops / (run.window_s * counts.BF16_FLOPS)
