"""Pipeline orchestration: configuration dataclasses and the scene
optimizer's front-end stages."""
