from divshot_tpu_torch.scene.components import (  # noqa: F401
    GaussianRenderType, GaussianComponent, GaussianCrop, CropVolume,
    CropType, Environment, EnvironmentMode, Light, LightType,
)
from divshot_tpu_torch.scene.scene import Scene, Entity  # noqa: F401
