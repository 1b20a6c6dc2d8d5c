"""The facade's own share of ``Chat.infer``: of the program's
``chat.infer`` spans in the traced calls, the time no child span covers
(normalizing, tokenizing, the speaker, assembling the result), in
percent."""

from harness import spans


def read(s):
    calls = spans.inside(s, "chat.infer")
    if not calls:
        return None
    ids = {sp.index for sp in calls}
    children = {}
    for sp in spans.stretch(s)[0]:
        if sp.parent in ids:
            children.setdefault(sp.parent, []).append(sp)
    total = spans.dur_us(calls)
    if total <= 0:
        return None
    own = sum(spans.self_us(sp, children.get(sp.index, ())) for sp in calls)
    return 100.0 * own / total
