"""The LM's share of the card's bf16 peak over the window: the model flops
of every query's answer (a prefill of the prompt and the decode steps of
its tokens; 2 a parameter a token passes through plus causal attention,
``roofline.lm_sequence_flops``) over window x 989 TFLOP/s."""
import roofline


def read(view):
    lm = view.cell.config.get("lm")
    gens = view.trees[""].stages("Generate") if "" in view.trees else []
    q = view.work.get("queries")
    if lm is None or not gens or not q or view.window_s <= 0:
        return None
    g = gens[0]
    flops = q * roofline.lm_sequence_flops(
        lm, int(g.param(2, "max_prompt_len")), int(g.param(1,
                                                         "max_new_tokens")))
    return flops / (view.window_s * roofline.BF16_FLOPS)
