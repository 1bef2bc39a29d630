from divshot_tpu_torch.edit.ops import (  # noqa: F401
    EditSession, STATE_SELECT, STATE_HIDE, STATE_DELETE, STATE_PAINT)
