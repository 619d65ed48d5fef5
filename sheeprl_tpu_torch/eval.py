"""``python -m sheeprl_tpu_torch.eval checkpoint_path=<...>/checkpoint/ckpt_N_0.ckpt [key=value ...] [device=cpu]``:
the evaluation command line (:func:`sheeprl_tpu_torch.cli.evaluation`)."""

from sheeprl_tpu_torch.cli import evaluation

if __name__ == "__main__":
    evaluation()
