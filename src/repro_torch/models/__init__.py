from repro_torch.models.cnn import cnn_error, cnn_forward, cnn_loss, init_cnn
from repro_torch.models.transformer import (decode_step, encode, forward,
                                            init_cache, init_params, lm_loss)

__all__ = ["cnn_error", "cnn_forward", "cnn_loss", "decode_step", "encode",
           "forward", "init_cache", "init_cnn", "init_params", "lm_loss"]
