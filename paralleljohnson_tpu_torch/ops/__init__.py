"""Device operations of the PyTorch port: plain relaxation primitives
(``relax``) and the hand CUDA kernels with their plain versions
(``fanout_sweep``, ``minplus``, ``pred``'s ``tight_pred``, ``fw``'s
``fw_kleene``; built by ``_cuda``)."""


def kernel_launches() -> dict[str, int]:
    """Each hand kernel's launch count in this process (the counters its
    wrapper adds one to per CUDA launch; CPU tensors never count)."""
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_sweep
    from paralleljohnson_tpu_torch.ops.fw import fw_kleene
    from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel
    from paralleljohnson_tpu_torch.ops.pred import tight_pred_pass

    return {"fanout_sweep": fanout_sweep.launches,
            "minplus": minplus_kernel.launches,
            "tight_pred": tight_pred_pass.launches,
            "fw_kleene": fw_kleene.launches}
