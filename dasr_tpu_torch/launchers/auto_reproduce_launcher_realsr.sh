#!/bin/sh
# realsr reproduction hyperparameters on the GPU (reference:
# codes/DSN/auto_reproduce_launcher_realsr.sh): launchers/auto_reproduce_launcher_realsr.sh
# with the dasr_tpu_torch CLIs, which run on the card (--device cuda) by default
python -m dasr_tpu_torch.cli.dsn_train --dataset realsr --artifacts tdrealsr \
    --generator DeResnet --discriminator FSD --filter avg_pool \
    --w_tex 0.005 --save_path 0603_DSN_realsr \
    --batch_size 8 --num_workers 8 --crop_size 128

python -m dasr_tpu_torch.cli.dsn_create_dataset --dataset realsr_tdrealsr \
    --checkpoint ../../DSN_experiments/0603_DSN_realsr/checkpoints \
    --generator DeResnet --discriminator FSD --filter avg_pool \
    --name 0603_DSN_LRs_realsr
