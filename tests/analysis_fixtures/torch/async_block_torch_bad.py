"""ASYNC-BLOCK (torch key) bad samples: a host sync inside an async
body stalls every coroutine on the loop until the device drains."""

import torch


async def infer(model, x):
    y = model(x)
    # BAD: waits for every queued kernel on the event loop's thread
    torch.cuda.synchronize()
    return y


async def infer_event(model, x):
    y = model(x)
    event = torch.cuda.Event()
    event.record()
    # BAD: Event.synchronize blocks the loop the same way
    event.synchronize()
    return y
