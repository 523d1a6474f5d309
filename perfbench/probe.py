"""The card's cost of a CUDA graph node, read apart from the program.

The same graph replay runs on an H100 at one of two steady speeds: in
many processes the program's first epoch turns the card slow, for a
few seconds to over a minute, and then it turns fast and stays so
(PERF.md).  A graph of ``nodes`` one-element additions tells the two
apart: on NVIDIA H100 80GB HBM3 cards at 700 W it replays at 0.987 to
1.016 us a node in the fast speed and at 1.165 to 1.191 us in the slow
one, on every card tried.  The set-up trains on until it reads under
``FAST_US``.
"""

from __future__ import annotations

import torch

#: microseconds a node under which the card runs at its fast speed
FAST_US = 1.10


class NodeProbe:
    """A captured graph of ``nodes`` additions to one float on
    ``device``, timed by CUDA events."""

    def __init__(self, device, nodes: int = 2000):
        self.device, self.nodes = device, nodes
        x = torch.zeros(1, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            x.add_(1.0)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(nodes):
                x.add_(1.0)
        self.x = x

    def us_per_node(self, reps: int = 5) -> float:
        """Microseconds a node over ``reps`` replays, after one more."""
        torch.cuda.synchronize(self.device)
        self.graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / (reps * self.nodes)

    def close(self) -> None:
        self.graph.reset()
        self.graph = self.x = None
