from dsrg_tpu_torch.data.cues import CueDB  # noqa: F401
from dsrg_tpu_torch.data.loader import PrefetchLoader  # noqa: F401
from dsrg_tpu_torch.data.voc import (  # noqa: F401
    Stage1Dataset,
    Stage2Dataset,
    load_image_bgr,
    preprocess_image,
    read_id_list,
    read_pair_list,
)
