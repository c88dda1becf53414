"""TL101 negative fixture: per-call launch geometry (the forest kernel's
``serve/packed.py`` idiom).

The constants below are compared against shapes, but the module keeps
no grower key and no capture signature: the geometry is computed per
call and handed to the launch, nothing is cached under it.  No plants:
TL101 must stay silent here.
"""

MAX_THREADS = 256
ROWS_PER_SM = 64
SMALL_REQUEST_PAIRS = 4096


def launch_geometry(rows, num_trees):
    threads = min(MAX_THREADS, max(32, rows))
    blocks = max(1, rows // ROWS_PER_SM)
    small = rows * num_trees <= SMALL_REQUEST_PAIRS
    return threads, blocks, small
