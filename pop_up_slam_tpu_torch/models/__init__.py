from .segmentation import (  # noqa: F401
    SegNetLite,
    classical_ground_mask,
    create_train_state,
    load_pretrained_segnet,
    predict_mask,
    save_segnet,
    train_step,
)
