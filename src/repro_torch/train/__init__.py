from repro_torch.train.step import (
    TrainState,
    chunked_cross_entropy,
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)

__all__ = ["TrainState", "chunked_cross_entropy", "init_train_state", "make_eval_step",
           "make_grad_fn", "make_train_step"]
