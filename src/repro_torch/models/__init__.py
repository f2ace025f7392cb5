from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, lm_loss)

__all__ = ["decode_step", "forward", "init_cache", "init_params", "lm_loss"]
