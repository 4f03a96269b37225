"""The packaged yaml files as Python dicts, so the predict path needs no yaml parser.

`DEFAULT_YAML` equals `yaml.safe_load(cfg/default.yaml)` and `YOLO11_YAML` equals
`yaml.safe_load(cfg/yolo11.yaml)`; tests/test_torch_model.py holds them to that.
Edit the yaml and the dict together.

`YOLOV10N` and `GELAN_T` are two specs of the extended block zoo, as dicts
(`DetectionModel(YOLOV10N)`): the rows of Ultralytics'
cfg/models/v10/yolov10n.yaml with `Detect [nc, True]` (the end2end head) in
place of v10Detect, and the backbone and neck rows of
cfg/models/v9/yolov9t.yaml with this package's Detect (the YOLO11 head).
"""

DEFAULT_YAML = {
    "task": "detect", "mode": "train",
    # Train
    "model": None, "data": None, "epochs": 100, "time": None, "patience": 100, "batch": 16,
    "imgsz": 640, "save": True, "save_period": -1, "cache": False, "device": None, "workers": 8,
    "project": None, "name": None, "exist_ok": False, "pretrained": True, "optimizer": "auto",
    "verbose": True, "seed": 0, "deterministic": True, "single_cls": False, "rect": False,
    "cos_lr": False, "close_mosaic": 10, "resume": False, "amp": False, "profile": False,
    "freeze": None, "multi_scale": False,
    # Val / test
    "val": True, "split": "val", "save_json": False, "save_hybrid": False, "conf": None,
    "iou": 0.7, "max_det": 300, "half": False, "int8": False, "dnn": False, "plots": True,
    # Predict
    "source": None, "vid_stride": 1, "stream_buffer": False, "visualize": False, "augment": False,
    "agnostic_nms": False, "classes": None, "embed": None,
    # Visualization
    "show": False, "save_frames": False, "save_txt": False, "save_conf": False, "save_crop": False,
    "show_labels": True, "show_conf": True, "show_boxes": True, "line_width": None,
    # Hyperparameters
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005, "warmup_epochs": 3.0,
    "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 7.5, "cls": 0.5, "dfl": 1.5,
    "label_smoothing": 0.0, "nbs": 64, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0, "perspective": 0.0,
    "flipud": 0.0, "fliplr": 0.5, "bgr": 0.0, "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0,
    "copy_paste_mode": "flip", "auto_augment": "randaugment",
    # Custom overrides file
    "cfg": None,
}

YOLO11_YAML = {
    "nc": 80,
    "scales": {
        "n": [0.5, 0.25, 1024],
        "s": [0.5, 0.5, 1024],
        "m": [0.5, 1.0, 512],
        "l": [1.0, 1.0, 512],
        "x": [1.0, 1.5, 512],
    },
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0: P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1: P2/4
        [-1, 2, "C3k2", [256, False, 0.25]],  # 2
        [-1, 1, "Conv", [256, 3, 2]],  # 3: P3/8
        [-1, 2, "C3k2", [512, False, 0.25]],  # 4
        [-1, 1, "Conv", [512, 3, 2]],  # 5: P4/16
        [-1, 2, "C3k2", [512, True]],  # 6
        [-1, 1, "Conv", [1024, 3, 2]],  # 7: P5/32
        [-1, 2, "C3k2", [1024, True]],  # 8
        [-1, 1, "SPPF", [1024, 5]],  # 9
        [-1, 2, "C2PSA", [1024]],  # 10
    ],
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 11 (yaml reads None as the string)
        [[-1, 6], 1, "Concat", [1]],  # 12
        [-1, 2, "C3k2", [512, False]],  # 13
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 14
        [[-1, 4], 1, "Concat", [1]],  # 15
        [-1, 2, "C3k2", [256, False]],  # 16: P3/8 out
        [-1, 1, "Conv", [256, 3, 2]],  # 17
        [[-1, 13], 1, "Concat", [1]],  # 18
        [-1, 2, "C3k2", [512, False]],  # 19: P4/16 out
        [-1, 1, "Conv", [512, 3, 2]],  # 20
        [[-1, 10], 1, "Concat", [1]],  # 21
        [-1, 2, "C3k2", [1024, True]],  # 22: P5/32 out
        [[16, 19, 22], 1, "Detect", ["nc"]],  # 23
    ],
}

YOLOV10N = {  # 2,775,504 parameters, 8.63 GFLOPs at 640
    "nc": 80,
    "scales": {"n": [0.33, 0.25, 1024]},
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0: P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1: P2/4
        [-1, 3, "C2f", [128, True]],  # 2
        [-1, 1, "Conv", [256, 3, 2]],  # 3: P3/8
        [-1, 6, "C2f", [256, True]],  # 4
        [-1, 1, "SCDown", [512, 3, 2]],  # 5: P4/16
        [-1, 6, "C2f", [512, True]],  # 6
        [-1, 1, "SCDown", [1024, 3, 2]],  # 7: P5/32
        [-1, 3, "C2f", [1024, True]],  # 8
        [-1, 1, "SPPF", [1024, 5]],  # 9
        [-1, 1, "PSA", [1024]],  # 10
    ],
    "head": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 11
        [[-1, 6], 1, "Concat", [1]],  # 12
        [-1, 3, "C2f", [512]],  # 13
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 14
        [[-1, 4], 1, "Concat", [1]],  # 15
        [-1, 3, "C2f", [256]],  # 16: P3/8 out
        [-1, 1, "Conv", [256, 3, 2]],  # 17
        [[-1, 13], 1, "Concat", [1]],  # 18
        [-1, 3, "C2f", [512]],  # 19: P4/16 out
        [-1, 1, "SCDown", [512, 3, 2]],  # 20
        [[-1, 10], 1, "Concat", [1]],  # 21
        [-1, 3, "C2fCIB", [1024, True, True]],  # 22: P5/32 out (CIB with RepVGGDW)
        [[16, 19, 22], 1, "Detect", ["nc", True]],  # 23: one2many and one2one branches
    ],
}

GELAN_T = {  # 1,796,592 parameters, 6.69 GFLOPs at 640
    "nc": 80,
    "backbone": [
        [-1, 1, "Conv", [16, 3, 2]],  # 0: P1/2
        [-1, 1, "Conv", [32, 3, 2]],  # 1: P2/4
        [-1, 1, "ELAN1", [32, 32, 16]],  # 2
        [-1, 1, "AConv", [64]],  # 3: P3/8
        [-1, 1, "RepNCSPELAN4", [64, 64, 32, 3]],  # 4
        [-1, 1, "AConv", [96]],  # 5: P4/16
        [-1, 1, "RepNCSPELAN4", [96, 96, 48, 3]],  # 6
        [-1, 1, "AConv", [128]],  # 7: P5/32
        [-1, 1, "RepNCSPELAN4", [128, 128, 64, 3]],  # 8
        [-1, 1, "SPPELAN", [128, 64]],  # 9
    ],
    "head": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 10
        [[-1, 6], 1, "Concat", [1]],  # 11
        [-1, 1, "RepNCSPELAN4", [96, 96, 48, 3]],  # 12
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 13
        [[-1, 4], 1, "Concat", [1]],  # 14
        [-1, 1, "RepNCSPELAN4", [64, 64, 32, 3]],  # 15: P3/8 out
        [-1, 1, "AConv", [48]],  # 16
        [[-1, 12], 1, "Concat", [1]],  # 17
        [-1, 1, "RepNCSPELAN4", [96, 96, 48, 3]],  # 18: P4/16 out
        [-1, 1, "AConv", [64]],  # 19
        [[-1, 9], 1, "Concat", [1]],  # 20
        [-1, 1, "RepNCSPELAN4", [128, 128, 64, 3]],  # 21: P5/32 out
        [[15, 18, 21], 1, "Detect", ["nc"]],  # 22
    ],
}
