"""Host-side data helpers of the port: the dialog templates and dataset, the
system prompts, the finetune dataset and sampler, and the pretraining
datasets over parquet or packed shards. Port of ``accessory_tpu/data``; its
exports, each module imported where it is named."""

from accessory_tpu_torch.data.alpaca import FinetuneDataset, FinetuneDistSampler  # noqa: F401
from accessory_tpu_torch.data.falcon import Falcon  # noqa: F401
from accessory_tpu_torch.data.falcon_packed import FalconPacked  # noqa: F401
from accessory_tpu_torch.data.system_prompt import format_prompt  # noqa: F401
