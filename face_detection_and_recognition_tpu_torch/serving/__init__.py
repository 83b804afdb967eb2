from .service import FaceService, ServiceConfig  # noqa: F401
