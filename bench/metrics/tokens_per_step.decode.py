"""Generated tokens per decode step of the slot engine (the program's
``_generate_slots.last_stats["decode_steps"]``, summed over the calls): the
slots that do useful work in each step."""


def read(rec):
    steps = rec.counters.get("decode_steps", 0)
    if not steps:
        return None
    return rec.counters["generated"] / steps
