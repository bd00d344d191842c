"""sam_decode_slot_use_pct: the share of the SAM decode's prompt slots that
held a prompt: 100 x the port's `masks.prompts` over `masks.prompt_slots`
(every camera decodes every slot of its frame's prompt bucket), counted
over the whole process: the warm-up, the window, the traced parts and the
sample's batches. None where the port keeps no such counters."""


def read(ctx):
    from cm3d_tpu_torch.utils import observability

    counters = getattr(observability, "COUNTERS", None)
    if not counters or not counters.get("masks.prompt_slots"):
        return None
    return 100.0 * counters["masks.prompts"] / counters["masks.prompt_slots"]
