from fancyrec_tpu_torch.losses.losses import (  # noqa: F401
    ContrastiveQueueState, contrastive_loss, crossclr_loss, init_queue_state,
    lab_loss, rank_weights, triplet_loss)
