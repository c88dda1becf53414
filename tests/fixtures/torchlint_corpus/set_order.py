"""TL005 fixture: set iteration order reaching the output —
the callback-dedupe bug class that engine.py avoids with an ordered
dedupe."""


def callback_order(callbacks):
    deduped = set(callbacks)
    out = []
    for cb in deduped:  # PLANT: TL005
        out.append(cb)
    return out


def feature_list(names):
    return list({n.lower() for n in names})  # PLANT: TL005


def joined(tags):
    return ",".join(set(tags))  # PLANT: TL005


def comprehension_over_set(rows):
    return [r * 2 for r in {1, 2, 3}]  # PLANT: TL005


def sorted_is_clean(tags):
    return ",".join(sorted(set(tags)))


def membership_is_clean(tags, t):
    return t in set(tags)


def reduction_is_clean(vals):
    return sum(set(vals)), len(set(vals)), max(set(vals))
