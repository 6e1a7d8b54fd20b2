#!/bin/sh
# aim2019 reproduction hyperparameters on the GPU (reference:
# codes/DSN/auto_reproduce_launcher_aim2019.sh): launchers/auto_reproduce_launcher_aim2019.sh
# with the dasr_tpu_torch CLIs, which run on the card (--device cuda) by default
python -m dasr_tpu_torch.cli.dsn_train --dataset aim2019 --artifacts tdsr \
    --generator DeResnet --discriminator FSD --filter avg_pool \
    --w_tex 0.006 --save_path 0603_DSN_aim2019 \
    --batch_size 8 --num_workers 8 --crop_size 256

python -m dasr_tpu_torch.cli.dsn_create_dataset --dataset aim2019 \
    --checkpoint ../../DSN_experiments/0603_DSN_aim2019/checkpoints \
    --generator DeResnet --discriminator FSD --filter avg_pool \
    --name 0603_DSN_LRs_aim2019
