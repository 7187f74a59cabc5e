"""`repro_torch.pipeline` — batch construction from a device-resident
epoch order, overlapped with the train step (`repro/pipeline/__init__.py`).

  device_order   the per-epoch root permutations of `batching/order.py`
                 computed on the device from two epoch words, element for
                 element equal to the numpy orders (rand / norand /
                 comm_rand)
  builder        `DeviceBatchBuilder`: the epoch's root order stays on the
                 device; `build(epoch, pos)` slices the batch's roots there
                 and runs the stream's own build body — no per-batch
                 host-to-device root transfer
  prefetch       `AsyncBatchStream`: a depth-k (default 2) queue filled by
                 a producer thread that builds on a CUDA side stream, a
                 drop-in `BatchStream` (same `Cursor` resume semantics,
                 bit-exact batch sequence) with a restarting watchdog

`GNNTrainer(pipeline="async")` and `train_once(pipeline="async")` select
it; `chip_smoke.py` phase 10 times sync against async on the card.
"""
from repro_torch.pipeline.builder import DeviceBatchBuilder, stage_times
from repro_torch.pipeline.device_order import (OrderSpec, device_epoch_order,
                                               order_bitmatch)
from repro_torch.pipeline.prefetch import AsyncBatchStream

__all__ = [
    "AsyncBatchStream", "DeviceBatchBuilder", "OrderSpec",
    "device_epoch_order", "order_bitmatch", "stage_times",
]
