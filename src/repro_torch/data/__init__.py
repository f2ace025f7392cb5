from repro_torch.data.pipeline import (DeviceDataset, Prefetcher,
                                       WorkerSharder, worker_batches)
from repro_torch.data.synthetic import (convex_dataset, mnist_like,
                                        token_stream)

__all__ = ["DeviceDataset", "Prefetcher", "WorkerSharder", "convex_dataset",
           "mnist_like", "token_stream", "worker_batches"]
