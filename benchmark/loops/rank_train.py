"""``fused_train``'s driving on a ranking set: one booster trained chunk
after chunk of fused iterations (``Booster.update_chunked``) until the
window ends, on rows grouped into queries.  Three changes:

* set-up hands the program the rows, their grades and the query sizes
  as card tensors (``Dataset(x, label=y, group=sizes)``), the sizes
  drawn by the configuration's generator (its ``query_sizes``);
* a traced stretch's facts add the query sizes and the count of
  label-ordered pairs, worked out here from the benchmark's own labels
  (``cost_rank``), which the ranking cell's metric readers count the
  gradient's work from;
* the judged trees are judged with the objective's reference bound to
  the queries (its ``bind``).
"""

from __future__ import annotations

import torch

from .. import cost_rank
from ..spec import load_file
from . import fused_train


class Loop(fused_train.Loop):
    def setup(self) -> None:
        import lightgbm_tpu_torch as lt
        n = int(self.cfg["train_rows"])
        shape = dict(queries=self.cfg["queries"],
                     longest_query=self.cfg["longest_query"])
        data = load_file(self.ctx.spec.bench / "data"
                         / f"{self.cfg['data']}.py")
        self.sizes = data.query_sizes(n, self.ctx.seed, 0, **shape)
        self.x, self.y = self.rows(0, n, **shape)
        self.pairs = cost_rank.label_ordered_pairs(self.y, self.sizes)
        self.ctx.log(f"queries: {len(self.sizes)} of {n} rows, the longest "
                     f"{int(self.sizes.max())}; {self.pairs} label-ordered "
                     f"pairs")
        self.chunk = int(self.mix["chunk"])
        ds = lt.Dataset(self.x, label=self.y,
                        group=self.sizes.to(self.ctx.device),
                        params=self.params())
        self.booster = lt.Booster(params=self.params(), train_set=ds)
        self.judge_at, self.starts, self.end = None, [], None
        self.chunks = 0
        self.step()
        self.codes = ds._handle.binned
        self.chunks = 0
        self.sync()

    def traced(self, profiler):
        facts = super().traced(profiler)
        facts.update(query_sizes=self.sizes.tolist(), pairs=self.pairs)
        return facts

    def objective(self):
        bounds = torch.cat([torch.zeros(1, dtype=torch.int64),
                            torch.cumsum(self.sizes, 0)])
        return super().objective().bind(bounds.tolist(), self.judge_params())
