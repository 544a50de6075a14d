from tpu_splat_torch.train.losses import l1_loss, l2_loss, ssim, psnr
