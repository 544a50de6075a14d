from tpu_splat_torch.isp.ppisp import ISPConfig, ISPParams, init_isp, apply_isp, isp_regularization
