"""Traffic of kind ``queue``: the mix's tasks as one queue handed to
``hetero_many_matmul`` (schedule under the mix's ``policy``, then run on
the sequential executor) with dense operands on the card; one queue after
another, closed loop."""
from __future__ import annotations

from repro_torch.core.hetero_matmul import hetero_many_matmul

from portbench import mix


class Traffic(mix.Traffic):
    unit = "queue"

    def run(self, s):
        outs, _ = hetero_many_matmul(self.sets[s], self.accel,
                                     policy=self.mix["policy"],
                                     block=int(self.config["block"]),
                                     device=self.device)
        return outs
