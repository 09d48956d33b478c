"""Progressive render orchestration (reference main.py:1964-2012,
2346-2371): keep a number of render passes in flight, fold each finished
pass into the accumulator, notify a callback, and re-enqueue while
rendering is active.  The reference pins ``os.cpu_count()`` concurrent
CPU jobs; on an accelerator the device pipelines the work, so in-flight
count simply controls dispatch depth.

Qt-free: callbacks fire on the asyncio loop; a GUI marshals them to its
main thread (the reference does this with a Qt signal, main.py:1615).

A copy of ``ray_tracing_tpu/editor/render.py`` whose only change is its
imports: it folds the passes into the port's ``RenderResult``, whose
``add`` copies a pass to the host (the copy waits for the pass's work
on the card).
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

import numpy as np

from ray_tracing_tpu_torch.render.renderer import RenderResult


class ProgressiveRenderController:
    """Owns one progressive render session over a
    ``ray_tracing_tpu_torch.v4ray.Renderer``."""

    def __init__(
        self,
        renderer,
        width: int,
        height: int,
        on_update: Optional[Callable[[np.ndarray, int], None]] = None,
        in_flight: int = 2,
    ):
        self.renderer = renderer
        self.result = RenderResult(width, height)
        self.on_update = on_update
        self.in_flight = in_flight
        self._active = False
        self._tasks: set = set()

    @property
    def iterations(self) -> int:
        return self.result.count

    def start(self) -> None:
        """Begin/resume progressive rendering (reference start_render,
        main.py:1982-1991)."""
        self._active = True
        loop = asyncio.get_running_loop()
        for _ in range(self.in_flight - len(self._tasks)):
            self._spawn(loop)

    def stop(self) -> None:
        """Stop enqueuing new passes; in-flight passes still land
        (reference stop_render drops the renderer, main.py:1993-1994)."""
        self._active = False

    async def drain(self) -> None:
        """Wait for in-flight passes to finish."""
        while self._tasks:
            await asyncio.gather(*tuple(self._tasks), return_exceptions=True)

    def _spawn(self, loop) -> None:
        task = loop.create_task(self._one_pass())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _one_pass(self) -> None:
        colors = await self.renderer.render()
        count = self.result.add(colors)
        if self.on_update is not None:
            self.on_update(self.result.mean(), count)
        # re-enqueue while active (reference render_result_available,
        # main.py:1971-1980)
        if self._active:
            self._spawn(asyncio.get_running_loop())

    async def render_passes(self, n: int) -> np.ndarray:
        """Convenience: run exactly n passes and return the mean image."""
        for _ in range(n):
            await self._one_pass_once()
        return self.result.mean()

    async def _one_pass_once(self) -> None:
        colors = await self.renderer.render()
        count = self.result.add(colors)
        if self.on_update is not None:
            self.on_update(self.result.mean(), count)
