"""How full the capacity engine's slots ran: the tokens it generated over
the window over its decode steps times its slots (the program's
``Engine.stats`` counters)."""


def read(s):
    steps = s.counters.get("steps")
    if not steps:
        return None
    return 100.0 * s.counters["tokens_generated"] / (steps
                                                     * s.counters["slots"])
