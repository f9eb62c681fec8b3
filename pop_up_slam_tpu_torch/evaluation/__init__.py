from .ate import associate, ate_rmse, horn_align, rpe  # noqa: F401
