from repro_torch.data.synthetic import convex_dataset, token_stream

__all__ = ["convex_dataset", "token_stream"]
