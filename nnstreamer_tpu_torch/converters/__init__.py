"""nnstreamer_tpu_torch.converters"""
