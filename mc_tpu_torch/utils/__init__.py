from mc_tpu_torch.utils.device import device_summary, nvidia_smi_name_power

__all__ = ["device_summary", "nvidia_smi_name_power"]
