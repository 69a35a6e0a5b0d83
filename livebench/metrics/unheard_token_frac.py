"""Scheduler's frontier cap (``core/scheduler.py``, the gateway's
``frontier_cap_s``): tokens delivered to the window's turns that their
client never played (cut by a barge-in) over the tokens delivered to
them; from the clients."""
from livebench.stats import heard_tokens

UNIT = "fraction"
MOVES = "ttfp_p90_ms"


def read(rec):
    turns = rec["turns"]
    sent = sum(len(t.recv) for t in turns)
    if not sent:
        return None
    return sum(len(t.recv) - heard_tokens(t) for t in turns) / sent
