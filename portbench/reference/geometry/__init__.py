from . import camera, plane, se3  # noqa: F401
