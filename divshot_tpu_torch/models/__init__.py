"""Scene models beside the splats: the learnable environment background."""
