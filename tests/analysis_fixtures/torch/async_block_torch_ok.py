"""ASYNC-BLOCK (torch key) clean samples: the sync runs on a worker
thread; the coroutine awaits it."""

import asyncio

import torch


async def infer(model, x):
    y = model(x)
    event = torch.cuda.Event()
    event.record()
    await asyncio.to_thread(event.synchronize)
    return y
