"""The render daemon: the gRPC front end of proto/render/service.proto."""
