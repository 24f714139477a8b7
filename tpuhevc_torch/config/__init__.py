"""Configuration: HM-compatible .cfg parsing + option mapping.

Counterpart of the reference's TAppCommon/program_options_lite.{h,cpp} and
TAppEncCfg (SURVEY.md §2.3): cascading `-c file` configs with `Key : value`
lines and CLI overrides, mapped onto EncoderConfig.
"""
