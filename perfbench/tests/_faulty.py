"""``python -m perfbench.tests._faulty <fault> <perfbench.run arguments>``:
a run of the benchmark with the program's timed path broken underneath,
for the tests that see ``correct`` come out false.

- ``unchanged``: every batch step returns the state it was given;
- ``half_batch``: every loss leaves out the second half of its batch
  and takes the mean over the rest;
- ``stale_batches``: the superbatch graphs' count input keeps the first
  superbatch staged into it, the later ones never copied in;
- ``first_beta``: every epoch's KL weight is epoch 0's.
"""

import sys


def plant(fault: str) -> None:
    from mmvae_tpu_torch.ops import nb_fast, vmfnb_fast
    from mmvae_tpu_torch.train import superbatch

    if fault == "unchanged":
        step = nb_fast.PackedFastStep.batch_step

        def batch_step(self, q, opt_state, *a, **k):
            _, _, report = step(self, q, opt_state, *a, **k)
            return q, opt_state, report

        nb_fast.PackedFastStep.batch_step = batch_step
    elif fault == "half_batch":
        for cls in (nb_fast.NBFastStep, vmfnb_fast.VMFNBFastStep):
            def _loss(self, q, x, c, ridx, eps, beta, include_const, boot,
                      _orig=cls._loss):
                if ridx is None:
                    h = x.shape[0] // 2
                    x, c = x[:h], c[:h]
                else:
                    h = ridx.shape[0] // 2
                    ridx = ridx[:h]
                eps = tuple(e[:h] for e in eps)
                return _orig(self, q, x, c, ridx, eps, beta, include_const,
                             boot)

            cls._loss = _loss
    elif fault == "stale_batches":
        put = superbatch.SuperbatchGraphs._put

        def _put(self, buf, xs, _orig=put):
            if buf is self.x and getattr(self, "_staged", False):
                return None
            if buf is self.x:
                self._staged = True
            return _orig(buf, xs)

        superbatch.SuperbatchGraphs._put = _put
    elif fault == "first_beta":
        set_epoch = superbatch.SuperbatchGraphs.set_epoch

        def first_beta(self, epoch, _orig=set_epoch):
            _orig(self, 0)
            self.epoch = float(epoch)

        superbatch.SuperbatchGraphs.set_epoch = first_beta
    else:
        raise ValueError(fault)


if __name__ == "__main__":
    plant(sys.argv[1])
    from perfbench.run import main

    sys.exit(main(sys.argv[2:]))
